#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``btia_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi``), build the CUDA kernels from
   ``btia_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch twin on the card, in bf16, and
   time the kernel, the twin and a PyTorch library yardstick with CUDA
   events: K1 in its BERT and both BTIA site forms, K2 and K3 at the shapes
   of the ``streaming_vitl`` serving step (16 images x 128 questions); K4 at
   that step's four shapes under ``disable_fused()`` (2048 x 32 <- 32,
   50 <- 32, 32 <- 50, 64 <- 82), two batch rows a tile timed against one
   where Sq <= 32; K1 at the ``vqa_med_full`` training sites (BERT 64 x 32, BTIA 197 x 32 and
   32 x 197) and K4 at its three training shapes, K3 at ViT-B and the AD
   head (64 x 2048 <- 229); K1, K2, K3 and K4 again at head widths 128,
   192 and 256 (6, 4 and 3 heads of a 768-wide model); then the backward
   pass of each autograd
   Function (K1-K4) against autograd through its twin; then K1/K2's
   attention core alone through its C entry (``btia_attn_core``, the
   short-sequence kernel of ``csrc/short_flash.cuh``) at every K1/K2 serve
   and train site shape and at head widths 128, 192 and 256 (K2 with its
   one shared query table), against ``attend_log2`` within max|ref|/32, the
   all-PAD row exactly 0, timed beside the twin, SDPA and the bytes bound;
   then K1/K2's
   projection GEMM (``gemm_bias_ws_kernel``) alone at each serve shape
   (q, kv and out with the residual of the text and BTIA-image rows, K2's
   kv and its out with the query residual repeating every 64 rows) and
   each ``vqa_med_full`` train shape, each
   element within one bf16 step of ``_proj_plain`` plus the residual's
   rounding, timed beside ``torch.addmm`` (the yardstick) and the bound;
   the same GEMM with ``Dense``'s epilogue (the f32 bias, at fc1 the
   tanh-GELU) at the eight Mlp products of the serve step (MLP_SITES)
   against an f32 reference of the same function, timed beside
   ``torch.addmm``, ``addmm`` then ``F.gelu`` and the chain ``Dense`` ran
   before (``check_mlp_gemm``);
   then the grouped expert GEMM (``ops/moe.py::grouped_gemm``,
   ``csrc/moe_gemm.cu``) at one MoE layer of ``kimivl-fanout-backlog``
   (MOE_SHAPE: ~23,000 tokens, each routed unevenly to 6 of 64 experts and
   to the 2 shared ones): the SwiGLU product K 2,048 -> 2 x 1,408 and the
   down product 1,408 -> 2,048 with each row's routing weight, every row of
   a block in use within one bf16 step of the twin (``_grouped_plain``) plus
   2e-6 of the largest value for every 768 of K, timed beside the twin, a
   per-expert bf16 ``torch.mm`` loop (the yardstick) and the bound; then one
   MoE layer of ``models/mla_moe.py`` at the published widths with the
   kernel's counter set to 0 just before and read just after (2 launches)
   (``check_moe_gemm``); then the MLA attention core (``ops/mla.py::
   mla_attention``, ``csrc/mla_attn.cu``) at one layer of that cell
   (MLA_SHAPE: 2,048 questions of 7-16 real ids of 32, 16 heads, q_nope 128
   + q_pe 64, v 128) against the twin (``_mla_plain``, the grid code), every
   element within one bf16 step plus 2^-8 of the largest |v|, timed through
   its C entry alone, the wrapper and the twin beside the bytes bound; then
   one ``MLA`` at the published widths with the counter set to 0 just
   before and read just after (1 launch) (``check_mla_attn``);
   then K3, K5 and the GEMM at the shapes a persistent schedule can get
   wrong (EDGE_ATTN, EDGE_GEMM: work-item and tile counts around one and two
   an SM, one row, M 1 / 127 / 129, every residual form) with the same
   tolerances; then K8 (the int8
   FFN product) at the eight FFN shapes of the int8 serve step, each element
   within one bf16 step, its row quantization equal to its twin's, timed
   whole and by kernel (quantize, GEMM), and through the model's road on
   the weight prepared once (equal to the entry bit for bit), beside
   ``torch._int_mm`` on the pre-quantized operands and a bf16
   ``torch.matmul``; the row-parallel road's entries (row amax, quantize at
   given amaxes, int32 accumulators, the epilogue on them) against their
   twins at the same shapes;
2b. the ops API at full width: one run through ``mha(impl="pallas")`` and
   ``mha()`` under ``set_attention_impl("pallas")`` at ViT-L/336
   self-attention, ``mha_bshd``'s long road at D = 96 (the AD head of
   ``vqa_med_full`` with ``model.num_heads=8``), ``bicross_attention(impl=
   "pallas")`` at the pooled BTIA shape, ``bicross_bshd`` on an unpooled
   577 x 64 tile and ``layernorm_fast`` at the serve step's LayerNorm shapes
   (and in f32), with every counter set to 0 just before and read just after
   (K5 = 3, K6 = 2, K7 = 5, the others 0); then K5, K6 and K7 against their
   plain twins (attention within max|twin|/32, K7 within one bf16 step per
   element or 1e-5 of the largest value), timed beside the twin, a library
   yardstick (SDPA, two SDPA calls, ``F.layer_norm``) and the bound; K5 at
   D = 8, 40, 64, 96, 100, 128, 136, 192, 200 and 256 (its four templates;
   D = 100 through the padded copy), masked and dense, on the long road's
   transposed views, at a batch of 1 and with a broadcast batch; K6 at
   D = 16 to 256 on strided views (above 128 through ``bicross_attention(
   impl="pallas")``) and its fully masked row against the mean of V; K7's
   row kernels at small shapes and its two-read kernel at widths 6144 and
   8192 (in place at 8192, at the text rows' 768 and at the ragged 1500);
   K7's backward kernel (``layernorm_backward``) against ``_ln_exact_vjp``
   at ``K7_BWD_SHAPES`` and on constant rows (the rounded variance 0, the
   clamp at its bound), bf16 and f32 (dx within one bf16 step, or 1e-5 of
   its row's largest; dscale and dbias within 1e-4 of their largest; two
   calls bitwise equal), timed beside the twin and
   ``native_layer_norm_backward``; and on f32 rows whose rounded variance
   is negative (the clamp cuts: ``check_layernorm_bwd_clamp``) against the
   clamped closed form on the kernel's own statistics and against the twin
   where the twin's variance rounds negative too; each Function's backward
   against autograd through its twin;
2c. the f32 and wide-head kernels: the CUDA-core attention of
   ``csrc/attn_simt.cu`` through each entry's CUDA half in f32 (K1's core at
   ``vqa_rad_lstm``'s 64 x 49 <- 32 and 32 <- 49, K2's 2048 x 64 <- 82 with
   its shared table, K3 at ViT-B, K4, K5 at ViT-L on transposed views, K6
   pooled, and K5 at D = 256: two output slices) within 1e-4 of the largest
   magnitude; the tensor-core attention of ``csrc/attn_wide.cu`` (thread
   block clusters of one block a column slice) in bf16 at head widths 384,
   512, 768 and 1024 (K1's core, K3, K4, K5, K6) and 300 (K5, the padded
   copy) within 1/32 of it, each call seen to move its kernel's counter,
   also timed through its C entry alone on the operands its launcher
   packed, with the host's share of the wrapper (wrapper - C entry) and
   the launcher's host time a call by line (host clock), and ptxas's
   registers and spills of each instance; the f32 GEMM of
   ``csrc/gemm_f32.cu`` at the fp32 forwards' projection shapes within
   1e-4; each timed beside its twin, SDPA or ``F.linear`` (TF32 off) and
   the bound at the operands' peak (67 TFLOP/s f32 on the CUDA cores, 989
   bf16);
3. serve a few requests through ``Predictor.predict_answers`` on the
   full-width ``streaming_vitl`` with seeded random weights (buckets of
   1-8 questions: under the fused sites' batch floor of 64, so K1 = K2 = 0
   and K3 = 24 a call, as in the reference), check the logits are finite
   and agree with the same model run on the CPU;
4. run the bench-shaped serve step (encode_image -> answer_questions ->
   top-k) with every launch counter set to 0 just before one step and read
   just after: K1 = 20, K2 = 1, K3 = 24, K7 = 74 (every standalone
   LayerNorm), the others 0 launches, and ``Dense``'s calls 92 on the
   epilogue GEMM and 1 on the chain (SERVE_DENSE_ROUTES); a second
   step prepares none of K1/K2's weights again (``prepare_once``); then
   time a few steps, counting the core's tensor-map cache hits; the same
   step under ``set_attention_impl("xla")`` (K7 = 103, the others 0), under
   ``disable_fused()`` (K3 = 24, K4 = 21, K7 = 103, the others 0) and with
   the models' LayerNorms on the plain formula (``plain_layernorms``, the
   road before they reached K7: K7 = 0), each timed, its logits within a
   tenth of the largest logit of the default step's; then the step's 74
   standalone LayerNorms counted by shape, each one K7 launch through
   ``layernorm`` and the plain formula never on a CUDA tensor, and K7, the
   plain formula and ``F.layer_norm`` timed at each;
4b. the same step on ``streaming_vitl`` with ``model.int8_ffn`` (same
   seeded weights): K1 = 20, K2 = 1, K3 = 24, K7 = 74 (held as phase 4's),
   K8 = 90, the others 0, timed steps (no weight prepared again after the
   first step) and peak memory, the same step timed on the plain
   LayerNorms with its logits against K7's, logits against the same model
   on the CPU,
   and top-1 agreement with the bf16 model (reported only);
4c. ``StreamingServer`` over the int8 model (16 x 128, top-5, two decode
   threads) on 40 requests of 1-128 template questions with ingest-size
   arrays, off-size arrays, JPEG bytes, DICOM bytes and one corrupt DICOM:
   plain, ``dedup_questions``, ``pack_pairs`` (pair budget 1024) and
   ``max_wait_ms`` on a sparse trickle. Each mode answers every good
   request exactly once, records exactly the corrupt one and agrees with
   ``Predictor`` on a sample; pairs/s and ``latency_summary()`` per mode;
5. train full-width ``vqa_med_full`` at batch 64 through ``Trainer`` on a
   synthetic VQA-Med corpus (64 images, 128 training pairs): one epoch with
   its val evaluation and checkpoint, ten steps on one repeated batch (the
   loss must be finite and fall), one of them with every counter set to 0
   just before and read just after (K1 = 20, K3 = 13, K4 = 20, K7 = 79,
   K7's backward 79, the others 0: K4 runs in the backward of every K1
   site; the plain LayerNorm formula never on the card), a timed run of
   steps, the same steps on the plain LayerNorms and an eval forward's
   logits on both roads, the test evaluation at batch 128 (K1 = 20, K3 =
   13, K4 = 0, K7 = 51), a checkpoint restore round trip, and one step's
   loss and gradients on the card against the same step on the CPU (full
   depth, dropout 0);
5b. full-width ``vqa_med_full`` with ``model.num_heads`` 6, 4 and 3 (BTIA
   and the AD head at head widths 128, 192 and 256) through ``Trainer``:
   for each, one train step with every counter set to 0 just before and
   read just after (K1 = 20, K3 = 13, K4 = 20, K7 = 79), then one eval
   forward of the batch on the card (K1 = 20, K3 = 13, K7 = 51) against the
   same model and weights on the CPU on two rows, logits within a tenth of
   the largest;
5d. full-width ``vqa_med_full`` with ``model.num_heads`` 2: BTIA and the AD
   head at head width 384 on the wide-head kernel, as phase 5b: one train
   step (K1 20 / K3 13 / K4 20 / K7 79, the wide-head kernel 17: 8 BTIA
   cores, the AD head, 8 K4 calls in the backward) and an eval forward (K1
   20 / K3 13 / K7 51, wide 9) against the CPU, then five eval forwards and five train steps
   timed (host clock, ending in a synchronize);
5c. full-width ``pathvqa_vit`` (ViT-B/16, BERT-base, 2 BTIA layers, an AD
   head of 256 answer queries over 4096 answers) through ``Trainer`` on a
   synthetic PathVQA corpus, ``train.steps_per_call`` cut from 8 to 1: one
   train step at batch 64 with every counter set to 0 just before and read
   just after (K1 = 16, K3 = 13, K4 = 16, K7 = 67: the head's 256 x 229
   score tile is above 32768, so it goes unfused to K3), then one eval
   forward (K1 = 16, K3 = 13, K7 = 47) against the same model and weights on the CPU on two rows,
   logits within a tenth of the largest;
6. full-width ``vqa_rad_lstm`` (ResNet-50 at 224, bi-LSTM 512, hidden 512,
   8 heads of 64, 2 BTIA layers, an mlp head over 512 answers), bf16: the
   16 x 128 serve step with every counter (K1..K8 and the two CUDA-core
   kernels) set to 0 just before and read just after (K1 4: its BTIA
   sites; K7 6), timed, and timed on the plain LayerNorms with its logits
   against K7's, one image's 64 questions against the CPU within a tenth
   of the largest logit; three ``Predictor`` requests (buckets under the
   batch floor: K7 14 each, no other kernel); one ``Trainer`` call of its
   registered 8 scanned steps at batch 64 on a synthetic VQA-RAD corpus (K1
   32, K4 32, K7 112; finite losses, the BatchNorm statistics moved), then
   one call each on the plain LayerNorms and on K7 again, timed; one eval
   forward (K1 4, K7 6) against
   the CPU on two rows; one train step against the CPU under each policy
   (bf16: loss, gradient norm and BatchNorm statistics within phase 5's
   bounds; fp32: the gradients too, K1 and K4 on the CUDA-core kernels; see
   ``train_step_card_vs_cpu``);
6b. full-width ``slake_bert`` (ResNet-50, BERT-base, 2 BTIA layers, mlp
   head), bf16, not timed: one serve step (K1 16: 12 BERT and 4 BTIA sites;
   K7 19), one train step through ``Trainer`` (K1 16, K4 16, K7 39), one
   eval forward, each against the CPU;
6c. the fp32 policy against the CPU within 1e-3 of the largest logit (f32
   on both sides with TF32 off, the convolutions' too): ``vqa_rad_lstm``'s
   eval forward at batch 64 (K1 4, each on 3 f32 GEMMs and the CUDA-core
   attention; K7 6 on f32 rows), ``streaming_vitl``'s serve step of 2
   images x 32 questions (K1 20, K2 1, K3 24, K7 74; CUDA-core attention 45,
   f32 GEMM 62), and ``tiny_test`` (K7 only: 24), one train step (loss and
   gradient norm within 1e-4) and a ``Predictor`` answer;
7. the user's entry points, each with every counter set to 0 just before
   and read just after: (7a) ``btia_tpu_torch.cli.main`` in this process,
   ``train`` (one epoch of full-width ``vqa_rad_lstm`` at batch 64 on a
   synthetic VQA-RAD corpus of 160 images: K1 4 a train step and a val
   batch, K4 4 a train step, K7 14 a train step and 6 a val batch),
   ``eval`` (K1 4, K7 6 a batch), ``predict`` on the corpus's DICOM (K7 14)
   and ``serve`` over the image directory with top-3, question dedup and
   batches of 8 images x 16 questions (K1 4, K7 6 a batch, warmup included;
   every image answered once); (7b) a
   reference-layout state_dict of a seeded ``vqa_rad_lstm`` (the converter's
   key rule run backwards) through ``cli convert``, then
   ``Predictor.from_checkpoint`` of the workdir against the seeded model on
   64 questions (K1 4), logits bitwise equal; (7c) ``python -m
   btia_tpu_torch.cli bench`` as a subprocess at its defaults
   (``streaming_vitl``, 16 x 128, 20 steps x 3 windows), its JSON line, then
   the bench's ``run`` in this process on ``streaming_vitl`` (K1 20, K2 1,
   K3 24, K7 74 a step) and ``vqa_rad_lstm`` (K1 4, K7 6 a step), each ``step_ms`` beside
   phases 4's and 6's; (7d) one ``vqa_med_full`` train step at batch 64 and
   dropout 0.1 without and with ``model.remat`` (same weights, batch and
   step generator): equal losses, gradients within 1e-6 of the largest (or
   the plain step's own rerun spread), the peak memory of each, and the
   remat step's launches (K1 28, K3 25, K4 20, K7 111: the backward
   recomputes the 8 BTIA sites and the 12 ViT-B blocks); (7e) the profiling hooks around
   the bench's serve step of ``vqa_rad_lstm`` (K1 4 a step): ``Timer.span``
   on CUDA events against the host clock, ``fetch``, ``memory_stats`` and a
   ``trace`` that holds the card's kernels;
8. the (data, model) mesh (``mesh_phase``): the script re-invokes itself
   (``--phase8-rank``) as two ranks on the one card, joined on gloo (NCCL
   refuses two ranks on one device; gloo stages each all-reduce through the
   host, so its times are two ranks time-sharing one card, not multi-GPU
   figures), each rank with a timeout and fatal if it fails; (8a)
   full-width ``streaming_vitl`` under its registered mesh (world 2 ->
   data 1, model 2) through ``make_sharded_serve_fn`` at 4 images x 64
   questions, the same seeded weights as a one-process step on the card:
   logits within a tenth of the largest, K1 20 / K2 1 / K3 24 / K7 86 a
   rank (every site on the rank's 6 or 8 heads; BERT's 12 post-LNs act on
   the model group's sum, outside K1), the bytes all-reduced a step equal to
   ``p8_reckoned_bytes``, each rank's peak memory and step time beside the
   one-process step's; (8b) ``Predictor(mesh=)`` on that model, a 1-image
   ``predict`` and ``predict_batch`` against a one-process Predictor; (8d)
   the same model with ``model.int8_ffn`` under the same mesh, fc2 on K8's
   row-parallel road: logits within a tenth of the largest of the
   one-process int8 step's, K1 20 / K2 1 / K3 24 / K7 86 / K8 90 a rank,
   the bytes all-reduced equal to ``p8_reckoned_bytes``' int8 reckoning;
   (8e) one tensor-parallel train step of ``streaming_vitl`` under the same
   mesh, at its registered widths with its depth cut to 2 ViT blocks, 2
   BERT layers and 2 BTIA layers, bf16, dropout 0, on 8 images x 8
   questions, against the one-process step on the card: the loss, the
   global gradient norm and every parameter after the step within
   ``P8E_BOUNDS``, K1 6 / K2 1 / K3 2 / K4 7 / K7 27 a rank (``P8E_COUNTS``),
   each rank's peak memory; (8c) one data-parallel (2, 1) ``vqa_rad_lstm``
   train step at 128 rows (64 a rank), bf16 and fp32, against the
   one-process step at 128 within ``P8_TRAIN_BOUNDS`` (K1 4 / K4 4 / K7 14
   a rank in bf16).

With ``--profile`` it also runs one serve step, one int8 serve step, one
train step, one ``vqa_rad_lstm`` serve step and one ``vqa_rad_lstm``
``Trainer`` call under ``torch.profiler`` and prints the device time by
kernel and by kind of PyTorch kernel, and the device's idle share.

It prints a ``summary`` line, a ``kernels`` JSON line of the eight kernel
entries, K7's backward kernel, the two CUDA-core kernels and the wide-head
kernel, each launched on a main path or the run fails (``launches``
is a kernel's count summed over the main-path runs: the serve step, the
int8 serve step, the train step, the ops API run of phase 2b, phase 5d's
train step and eval forward, the serve steps and train runs of phases 6
and 6b, the fp32 forwards of phase 6c and the CLI commands, the converted
checkpoint's forward, the bench runs, the remat train step and the
profiled serve steps of phase 7, and each rank's serve step, Predictor
calls and train steps of phase 8; K7's count is its two entries,
``layernorm`` and ``layernorm_fast``, together; its backward kernel has a
line of its own, ``layernorm_backward``, counted in every train step;
``launches_by_path`` splits it), the total run time, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. It exits non-zero, and prints no
result, when no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM dense peaks (NVIDIA data sheet): bf16 and int8 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

B_IMG, N_Q, SEQ, N_IMG_TOK = 16, 128, 32, 50  # serving-step shape
TIMED_STEPS = 5
B_TRAIN, N_VIT_B = 64, 197  # vqa_med_full: train batch, ViT-B/16 tokens
REPEATS, TIMED_TRAIN_STEPS = 10, 5
# Launches (K1, K2, K3, K4, K7) of one vqa_med_full step. Train: 12 BERT + 8
# BTIA K1 sites, 12 ViT blocks + the AD head's 2048 x 229 attention on K3
# (score tiles above 32768), and K4 in the backward of each K1 site (batch
# 64). K7 (every standalone LayerNorm, ``layernorm``): the forward's 63 (ViT
# 2 x 12 + 1, img_ln, BERT's embedding LN and 12 ln_mlp, at train time also
# its 12 post-LNs, txt_ln, BTIA's 8, the unfused AD head's kv LN, ln_mlp and
# ln_out) and 16 more in the backward, whose recompute of each BTIA site
# runs its q and kv LNs (at dropout 0 the post-LNs run in K1's chain and
# again in the backward's recompute: 79 too); an eval forward 51. K7's
# backward kernel (the ninth count, ``layernorm_backward``): one launch for
# each of those 79, forward and recompute alike, none in an eval forward.
TRAIN_COUNTS, EVAL_COUNTS = [20, 0, 13, 20, 0, 0, 79, 0, 79], [20, 0, 13, 0, 0, 0, 51, 0, 0]
# model.num_heads of a 768-wide model that give K1-K4 their wider tiles:
# head widths 128, 192 and 256.
WIDE_HEADS = (6, 4, 3)
# K8 (int8_matmul_fused) at the FFN products of one int8 serve step of
# streaming_vitl, 16 images x 128 questions: (site, M, K, N, activation,
# launches per step). BERT's 12 Mlps and BTIA's 4 mlp_txt share the
# 2048 x 32-token shape; 90 launches in all.
INT8_SITES = (
    ("vit_fc1", B_IMG * 577, 1024, 4096, "gelu_tanh", 24),
    ("vit_fc2", B_IMG * 577, 4096, 1024, None, 24),
    ("txt_fc1", B_IMG * N_Q * SEQ, 768, 3072, "gelu_tanh", 16),
    ("txt_fc2", B_IMG * N_Q * SEQ, 3072, 768, None, 16),
    ("img_fc1", B_IMG * N_Q * N_IMG_TOK, 768, 3072, "gelu_tanh", 4),
    ("img_fc2", B_IMG * N_Q * N_IMG_TOK, 3072, 768, None, 4),
    ("head_fc1", B_IMG * N_Q * 64, 768, 1536, "gelu_tanh", 1),
    ("head_fc2", B_IMG * N_Q * 64, 1536, 768, None, 1),
)
# The same eight FFN products in bf16 (the serve step's 45 Mlps: ViT-L's 24,
# BERT's 12, BTIA's 4 + 4, the AD head's), on the projection GEMM with the
# bias, and at fc1 the tanh-GELU, in its epilogue: Dense's road on the card.
MLP_SITES = INT8_SITES
# K8 at a K above 4096, where its row quantization takes its two-pass
# kernel (no FFN of a registered config is that wide): held like the eight.
INT8_WIDE_K = ("wide_k", 4096, 8192, 1024, "gelu_tanh", 0)
# K7 74 a serve step: its standalone LayerNorms (SERVE_LN_CENSUS).
SERVE_COUNTS, INT8_COUNTS = [20, 1, 24, 0, 0, 0, 74, 0, 0], [20, 1, 24, 0, 0, 0, 74, 90, 0]
# Dense calls of one bf16 serve step by route (``Dense.epilogue_calls``,
# ``Dense.chain_calls``): 93 in all (ViT-L's patch embedding and 24 Mlps,
# img_proj, txt_proj, BERT's 12 Mlps, BTIA's 4 x 2, the AD head's one); the
# patch embedding's K = 588 is no multiple of 8, so it keeps the chain.
SERVE_DENSE_ROUTES = (92, 1)
# One Predictor call (one image, a bucket of at most 32 questions): every
# K1/K2 site is under the batch floor of 64 and takes the unfused road (its
# short attention on the plain road, under K4's floor too); ViT-L keeps K3.
# K7 103: the serve step's 74, the 12 BERT post-LNs, the q and kv LNs of the
# 8 BTIA sites and the AD head's kv LN, which the unfused sites run alone.
PREDICT_COUNTS = [0, 0, 24, 0, 0, 0, 103, 0, 0]
# pathvqa_vit (phase 5c): 12 BERT + 4 BTIA K1 sites, 12 ViT blocks + the AD
# head's 256 x 229 attention (above 32768: unfused, K3), K4 in the backward
# of each K1 site; K7 as vqa_med_full's with 2 BTIA layers (59 + 8; 47), a
# backward launch for each of the train step's 67.
PATHVQA_TRAIN_COUNTS, PATHVQA_EVAL_COUNTS = [16, 0, 13, 16, 0, 0, 67, 0, 67], [16, 0, 13, 0, 0, 0, 47, 0, 0]
# K1/K2's projection GEMM at the serve step's shapes: (name, M, K, N, rows
# the residual repeats over (0: none), launches per serve step). Text rows
# 2048 x 32, BTIA image rows 2048 x 50, the AD head's 2048 x 82 kv rows and
# 2048 x 64 query rows. 12 BERT sites (q, kv, out) + 4 BTIA layers x 2
# directions + K2 (kv, out): 62 launches.
GEMM_SITES = (
    ("text_q", B_IMG * N_Q * SEQ, 768, 768, 0, 16),
    ("text_kv", B_IMG * N_Q * SEQ, 768, 1536, 0, 16),
    ("text_out", B_IMG * N_Q * SEQ, 768, 768, B_IMG * N_Q * SEQ, 16),
    ("image_q", B_IMG * N_Q * N_IMG_TOK, 768, 768, 0, 4),
    ("image_kv", B_IMG * N_Q * N_IMG_TOK, 768, 1536, 0, 4),
    ("image_out", B_IMG * N_Q * N_IMG_TOK, 768, 768, B_IMG * N_Q * N_IMG_TOK, 4),
    ("head_kv", B_IMG * N_Q * (N_IMG_TOK + SEQ), 768, 1536, 0, 1),
    ("head_out", B_IMG * N_Q * 64, 768, 768, 64, 1),
)
# The same at the vqa_med_full train step's shapes (batch 64: text rows
# 64 x 32, image rows 64 x 197; under train-time dropout no site adds its
# residual): 12 BERT sites + 4 BTIA layers x 2 directions, 60 launches.
GEMM_TRAIN_SITES = (
    ("train_text_q", B_TRAIN * SEQ, 768, 768, 0, 16),
    ("train_text_kv", B_TRAIN * SEQ, 768, 1536, 0, 16),
    ("train_text_out", B_TRAIN * SEQ, 768, 768, 0, 16),
    ("train_image_q", B_TRAIN * N_VIT_B, 768, 768, 0, 4),
    ("train_image_kv", B_TRAIN * N_VIT_B, 768, 1536, 0, 4),
    ("train_image_out", B_TRAIN * N_VIT_B, 768, 768, 0, 4),
)
# K1/K2's attention core alone, through its C entry (the short-sequence
# kernel, csrc/short_flash.cuh), at each site shape of the serve and train
# steps and at the wide heads of phases 2 and 5b: (name, B, Sq, Sk, heads of
# a 768-wide model, key mask, K2's shared query table, launches per serve
# step, per train step). Serve: 12 BERT sites 32 <- 32, 4 BTIA img <- txt
# 50 <- 32 and 4 txt <- img 32 <- 50 (no mask), K2's 64 answer queries over
# 82 tokens; train: 12 BERT 32 <- 32, 4 + 4 BTIA 197 <- 32 and 32 <- 197.
BQ = B_IMG * N_Q
CORE_SITES = (
    ("serve_bert", BQ, SEQ, SEQ, 12, True, False, 12, 0),
    ("serve_i2t", BQ, N_IMG_TOK, SEQ, 12, True, False, 4, 0),
    ("serve_t2i", BQ, SEQ, N_IMG_TOK, 12, False, False, 4, 0),
    ("serve_k2", BQ, 64, N_IMG_TOK + SEQ, 12, True, True, 1, 0),
    *((f"serve_k2_d{768 // h}", BQ, 64, N_IMG_TOK + SEQ, h, True, True, 0, 0) for h in WIDE_HEADS),
    ("train_bert", B_TRAIN, SEQ, SEQ, 12, True, False, 0, 12),
    ("train_i2t", B_TRAIN, N_VIT_B, SEQ, 12, True, False, 0, 4),
    ("train_t2i", B_TRAIN, SEQ, N_VIT_B, 12, False, False, 0, 4),
    *((f"train_{site}_d{768 // h}", B_TRAIN, sq, SEQ, h, True, False, 0, 0)
      for h in WIDE_HEADS for site, sq in (("bert", SEQ), ("i2t", N_VIT_B))),
)
# K5 at every padded-width template (64, 128, 192, 256), at widths that are
# not multiples of 64, and at D = 100, which takes the wrapper's padded copy.
K5_WIDTHS = (8, 40, 64, 96, 100, 128, 136, 192, 200, 256)
# K6 at every padded-width template of its kernel (64, 128, 192, 256), at
# widths that are not multiples of 64, and at D = 100 (the padded copy).
K6_WIDTHS = (16, 32, 48, 80, 100, 112, 128, 136, 192, 256)
# Counts are listed K1..K8 (KERNELS). The serve step with the fused sites
# disabled: each K1/K2 site's unfused road sends its short attention
# (2048 rows, D = 64) to K4: 12 BERT + 8 BTIA + 1 AD head; ViT keeps K3;
# K7 103, as a Predictor call's. Under set_attention_impl("xla") no
# attention kernel runs, and the LayerNorms the same 103.
NO_FUSED_COUNTS = [0, 0, 24, 21, 0, 0, 103, 0, 0]
XLA_COUNTS = [0, 0, 0, 0, 0, 0, 103, 0, 0]
# The serve step with the models' LayerNorms on the plain formula
# (``plain_layernorms``: the road before they reached K7), for the before /
# after comparison within one run.
PLAIN_LN_SERVE_COUNTS = SERVE_COUNTS[:6] + [0, 0, 0]
# K4 at those 21 launches' shapes (name, Sq, Sk, masked): 12 BERT sites
# 32 <- 32, 4 BTIA img <- txt 50 <- 32 and 4 txt <- img 32 <- 50 (dense),
# the AD head's 64 answer queries over 82 tokens.
K4_SERVE_SHAPES = (("k4_serve_bert", SEQ, SEQ, True), ("k4_serve_i2t", N_IMG_TOK, SEQ, True),
                   ("k4_serve_t2i", SEQ, N_IMG_TOK, False), ("k4_serve_head", 64, N_IMG_TOK + SEQ, True))
# K1..K8, then K7's backward kernel (``layernorm_backward``, csrc/layernorm.cu).
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K7_bwd")
# Phase 2b, the ops API at full width, on registered configs' shapes: K5 at
# ViT-L/336 self-attention (mha(impl="pallas")) and at the AD head of
# vqa_med_full with model.num_heads=8 (D = 96: 2048 answer queries over
# 197 + 32 tokens at batch 64, mha_bshd's long road); K6 at the pooled BTIA
# serving shape and on an unpooled ViT-L tile with model.max_question_len=64
# (bicross_bshd's long road); K7 at the serve step's standalone LayerNorms.
K5_VITL = (B_IMG, 16, 577, 577, 64)  # (B, H, Sq, Sk, D)
K5_HEAD = (B_TRAIN, 8, 2048, N_VIT_B + SEQ, 96)
K6_POOLED = (B_IMG * N_Q, 12, N_IMG_TOK, SEQ, 64)  # (B, H, Ni, Nt, D)
K6_LONG = (B_IMG, 12, 577, 64, 64)
K7_SHAPES = (("vit_l", B_IMG * 577, 1024), ("btia_image", B_IMG * N_Q * N_IMG_TOK, 768),
             ("text", B_IMG * N_Q * SEQ, 768), ("head", B_IMG * N_Q * 64, 768))
# K7's backward kernel (phase 2b), (name, rows, width): ViT-B's LayerNorms in
# a vqa_med_full train step (64 x 197 tokens), BERT's (64 x 32), ViT-L's at the
# serve batch (16 x 577: the width of phase 8e's streaming_vitl train step and
# of --train-mesh, two warps a bf16 row), vqa_rad_lstm's image and text rows
# at its width of 512 (64 x 49, 64 x 32), a ragged width and a row past the
# register kernels; each in bf16 and f32, and BERT's shape again with
# constant rows, where the variance's clamp sits at its bound.
K7_BWD_SHAPES = (("vit_b", B_TRAIN * N_VIT_B, 768), ("bert", B_TRAIN * SEQ, 768), ("vit_l", B_IMG * 577, 1024),
                 ("lstm_image", B_TRAIN * 49, 512), ("lstm_text", B_TRAIN * SEQ, 512),
                 ("ragged", 3000, 1500), ("wide", 2048, 8192))
# f32 widths of check_layernorm_bwd_clamp: one warp a row (768), two (1024),
# one element a lane (the ragged 1500) and the two-read kernel (8192).
K7_CLAMP_WIDTHS = (768, 1024, 1500, 8192)
# The phase's main-path run: mha(impl="pallas"), mha() under
# set_attention_impl("pallas") and mha_bshd at D = 96 on K5;
# bicross_attention(impl="pallas") and bicross_bshd on K6; layernorm_fast at
# the four K7 shapes in bf16 and at ViT-L's in f32.
OPS_COUNTS = [0, 0, 0, 0, 3, 2, 5, 0, 0]
# Standalone LayerNorms (each one K7 launch) of one bf16 serve step, by
# (rows, width): ViT-L's 24 x 2 + final; BERT's embedding LN and 12 ln_mlp,
# txt_ln and BTIA's 4 ln_txt2 on the 2048 x 32 text tokens; img_ln on the
# 16 x 50 pooled tokens; BTIA's 4 ln_img2; the AD head's ln_mlp and ln_out.
SERVE_LN_CENSUS = {(B_IMG * 577, 1024): 49, (B_IMG * N_IMG_TOK, 768): 1,
                   (B_IMG * N_Q * SEQ, 768): 18, (B_IMG * N_Q * N_IMG_TOK, 768): 4,
                   (B_IMG * N_Q * 64, 768): 2}
# Phase 2c, the f32 and wide-head kernels (csrc/attn_simt.cu,
# csrc/gemm_f32.cu on the CUDA cores, csrc/attn_wide.cu on the tensor
# cores): the f32 attention at each entry's shape on the fp32 path (name,
# entry, dims), among them K2 and K3 as phase 6c's streaming_vitl serve step
# gives them (64 pairs; 2 ViT-L images of 577 tokens), and one f32 head of
# 256 (two output slices); bf16 at head widths 384 to 1024 (heads of a 768-
# or 1024-wide model) and at 300 (the padded copy).
# The bound takes the card's peak for the operands' type: f32 at 67 TFLOP/s
# (H100 SXM, NVIDIA's data sheet: f32 outside the tensor cores, which f32
# operands cannot use without rounding), bf16 at the bf16 tensor-core peak.
PEAK_F32_SIMT = 67e12
SIMT_F32_CASES = (
    ("k1_core_f32_i2t", "core", dict(B=B_TRAIN, Sq=49, Sk=SEQ, H=8, D=64, masked=True)),
    ("k1_core_f32_t2i", "core", dict(B=B_TRAIN, Sq=SEQ, Sk=49, H=8, D=64, masked=False)),
    ("k2_core_f32", "core", dict(B=BQ, Sq=64, Sk=N_IMG_TOK + SEQ, H=12, D=64, masked=True, shared=True)),
    ("k2_core_f32_b64", "core", dict(B=B_TRAIN, Sq=64, Sk=N_IMG_TOK + SEQ, H=12, D=64, masked=True, shared=True)),
    ("k3_f32_vitb", "k3", dict(B=B_TRAIN, Sq=N_VIT_B, Sk=N_VIT_B, H=12, D=64, masked=False)),
    ("k3_f32_vitl", "k3", dict(B=2, Sq=577, Sk=577, H=16, D=64, masked=False)),
    ("k4_f32_i2t", "k4", dict(B=B_TRAIN, Sq=49, Sk=SEQ, H=8, D=64, masked=True)),
    ("k5_f32_vitl", "k5", dict(B=B_IMG, Sq=577, Sk=577, H=16, D=64, masked=False)),
    ("k6_f32_pooled", "k6", dict(B=BQ, Sq=N_IMG_TOK, Sk=SEQ, H=12, D=64, masked=True)),
    ("k5_f32_d256", "k5", dict(B=2, Sq=577, Sk=577, H=4, D=256, masked=True)),
)
WIDE_D = ((384, 2), (512, 2), (768, 1), (1024, 1))  # (D, heads)
SIMT_WIDE_SHAPES = {"core": (B_TRAIN, 49, SEQ), "k3": (B_TRAIN, N_VIT_B, N_VIT_B), "k4": (B_TRAIN, 49, SEQ),
                    "k5": (B_IMG, 577, 577), "k6": (B_TRAIN, N_IMG_TOK, SEQ)}
# The wide kernel at a head width that is not a multiple of 8 (K5, one
# zero-padded copy of q, k and v; two slices of 192 over 304 columns).
WIDE_ODD = ("k5_bf16_d300", "k5", dict(B=B_IMG, Sq=577, Sk=577, H=1, D=300, masked=True))
# The f32 GEMM at the projection shapes of the fp32 forwards of phase 6c
# (name, M, K, N, residual rows): vqa_rad_lstm's BTIA img <- txt site at
# batch 64 (49 image and 32 text tokens, width 512) and streaming_vitl's
# serve step of 64 pairs (BERT text rows, K2's 82-token kv rows, width 768).
GEMM_F32_SITES = (
    ("lstm_i2t_q", B_TRAIN * 49, 512, 512, 0),
    ("lstm_i2t_kv", B_TRAIN * SEQ, 512, 1024, 0),
    ("lstm_i2t_out", B_TRAIN * 49, 512, 512, B_TRAIN * 49),
    ("vitl_text_kv", B_TRAIN * SEQ, 768, 1536, 0),
    ("vitl_text_out", B_TRAIN * SEQ, 768, 768, B_TRAIN * SEQ),
    ("vitl_head_kv", B_TRAIN * (N_IMG_TOK + SEQ), 768, 1536, 0),
)
NEW_KERNELS = ("simt_attention", "gemm_f32", "wide_attention")
# Phase 6, vqa_rad_lstm (ResNet-50, bi-LSTM, 2 BTIA layers at 8 heads of
# 64, mlp head), bf16: K1 at its 4 BTIA sites (49 image tokens, 32 text) a
# forward; in training K4 in the backward of each. Counts K1..K8 and then
# NEW_KERNELS: the two CUDA-core kernels and the wide-head kernel. K7: img_ln,
# txt_ln and BTIA's 4 a forward; a train step 8 more in the backward (the
# recompute of each BTIA site's q and kv LNs), and K7's backward kernel once
# for each of the 14; a Predictor request (under the batch floor: the sites
# unfused) 14, the sites' 8 LNs outside K1.
LSTM_SERVE_COUNTS = [4, 0, 0, 0, 0, 0, 6, 0, 0, 0, 0, 0]
LSTM_TRAIN_STEP_COUNTS = [4, 0, 0, 4, 0, 0, 14, 0, 14, 0, 0, 0]
LSTM_PREDICT_COUNTS = [0, 0, 0, 0, 0, 0, 14, 0, 0, 0, 0, 0]
# Phase 6b, slake_bert (ResNet-50, BERT-base, 2 BTIA layers at 12 heads of
# 64, mlp head): 12 BERT + 4 BTIA K1 sites. K7: img_ln, BERT's 13, txt_ln
# and BTIA's 4 a forward; a train step adds BERT's 12 post-LNs (dropout
# outside K1) and 8 in the backward; K7's backward kernel once for each of
# the 39.
SLAKE_SERVE_COUNTS = [16, 0, 0, 0, 0, 0, 19, 0, 0, 0, 0, 0]
SLAKE_TRAIN_COUNTS = [16, 0, 0, 16, 0, 0, 39, 0, 39, 0, 0, 0]
# Phase 6c, the fp32 policy: vqa_rad_lstm's eval forward at batch 64 (4 K1
# sites, each 3 f32 GEMMs and one CUDA-core core); streaming_vitl's serve
# step of 2 images x 32 questions (20 K1 sites, K2, 24 ViT-L blocks on K3,
# all on the CUDA-core attention: 45; 60 + 2 f32 GEMMs); tiny_test none.
# K7 as the bf16 forwards' (6, 74); tiny_test's train step at 4 rows and
# its two Predictor forwards of 3 questions, all under the batch floor: 8
# each (img_ln, txt_ln, its BTIA layer's 2 and its unfused sites' 4), and
# the train step's 8 backward launches.
F32_LSTM_COUNTS = [4, 0, 0, 0, 0, 0, 6, 0, 0, 4, 12, 0]
F32_VITL_COUNTS = [20, 1, 24, 0, 0, 0, 74, 0, 0, 45, 62, 0]
F32_TINY_COUNTS = [0, 0, 0, 0, 0, 0, 24, 0, 8, 0, 0, 0]
# Phase 5d, vqa_med_full with model.num_heads=2 (BTIA and the AD head at
# head width 384; BERT and ViT-B at 12 heads of 64): a train step's 8 BTIA
# K1 sites, the AD head's K3 call and the 8 K4 calls of those sites'
# backward run on the wide-head kernel (17); an eval forward 8 + 1.
WIDE_KERNEL_HEADS = 2
WIDE_KERNEL_COUNTS = ([20, 0, 13, 20, 0, 0, 79, 0, 79, 0, 0, 17], [20, 0, 13, 0, 0, 0, 51, 0, 0, 0, 0, 9])
# Phase 7, the user's entry points on the card. The CLI on vqa_rad_lstm
# (bf16, 2 BTIA layers): K1 at its 4 BTIA sites a forward of 64 rows or
# more, K4 in the backward of each in a train step. `serve` runs batches of
# CLI_SERVE_BATCH images x the 16 CLI_QUESTIONS (128 rows: the fused sites'
# batch floor of 64 admits K1), one warmup batch first.
CLI_SERVE_BATCH = 8
CLI_QUESTIONS = ("is the lung normal", "is there a fracture", "is the heart enlarged", "is this an mri",
                 "does the chest show pleural effusion", "is the lesion on the left", "is there a mass",
                 "is the liver normal", "is the kidney normal", "is there free air", "is this a ct",
                 "is the trachea midline", "is there cardiomegaly", "is the bowel dilated",
                 "is there a pneumothorax", "is the spleen enlarged")
# The bench (python -m btia_tpu_torch.bench) at its defaults, a step:
# streaming_vitl as phase 4's serve step, vqa_rad_lstm as phase 6's.
BENCH_STEP_COUNTS = {"streaming_vitl": SERVE_COUNTS + [0, 0, 0], "vqa_rad_lstm": LSTM_SERVE_COUNTS}
# A vqa_med_full train step with model.remat: the plain step's launches
# (TRAIN_COUNTS) and the recompute's, in the backward pass, of the 8 BTIA K1
# sites and the 12 ViT-B blocks' K3 calls and LayerNorms (K7 79 + 24 + 8);
# the AD head is not recomputed. K7's backward kernel 79: the recompute's
# graph feeds the forward's nodes, one backward each.
REMAT_COUNTS = [28, 0, 25, 20, 0, 0, 111, 0, 79, 0, 0, 0]
# The steps' ms before the models' LayerNorms reached K7: this script's runs
# on the tree before that change (H100 80GB HBM3, 700 W; PERF.md section 5),
# logged beside this run's for the record. The comparison that counts is
# within one run: each step again under plain_layernorms().
BEFORE_K7_MS = {"serve": (133.82, 135.62, 134.28), "int8_serve": (108.30, 109.52, 109.27),
           "train": (218.04, 256.87, 221.57), "vqa_rad_lstm_serve": (37.2, 44.0),
           "vqa_rad_lstm_train_step": (291.0, 398.0)}


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _flat_f32(out):
    """A kernel's output (a tensor, or a tuple of them) as one f32 vector."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([t.float().flatten() for t in outs])


def run_case(name, kernel, plain, library, flops, nbytes_, iters=10):
    """Hold an attention kernel against its plain twin and time the kernel,
    the twin and the library yardstick (CUDA events) beside the bound."""
    import torch

    out = _flat_f32(kernel())
    torch.cuda.synchronize()
    ref = _flat_f32(plain())
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (out - ref).abs().max().item()
    # Eight bf16 steps at the output's largest magnitude: the kernel and
    # its twin round the bf16 projections after sums taken in another
    # order, and a flipped rounding propagates through the softmax.
    tol = ref.abs().max().item() / 32
    del out, ref
    row = {
        "max_abs_err": err,
        "tol": tol,
        "ms": cuda_time_ms(kernel, iters),
        "plain_ms": cuda_time_ms(plain, max(2, iters // 4)),
        "library_ms": None if library is None else cuda_time_ms(library, iters),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes_)
    log(f"  {name}: err {err:.4g} (tol {tol:.4g}) kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']}, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin: {err} > {tol}")
    return row


def check_kernels(torch, dev):
    """Phase 2: each kernel against its plain twin at main-path shapes."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import fused_attn as FA

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    D, H, HDv = 768, 12, 1024

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def weights(din, hd, dout):
        w = lambda i, o: randn(i, o, std=i**-0.5, dtype=torch.float32)
        b = lambda n: randn(n, std=0.02, dtype=torch.float32)
        return [w(din, hd), b(hd), w(din, hd), b(hd), w(din, hd), b(hd), w(hd, dout), b(dout)]

    def ln(d, eps):
        return (1 + randn(d, std=0.1, dtype=torch.float32), randn(d, std=0.1, dtype=torch.float32), eps)

    def question_mask(n, s):
        lengths = torch.randint(4, s + 1, (n,), generator=g, device=dev)
        m = torch.arange(s, device=dev)[None, :] < lengths[:, None]
        m[-1] = False  # an all-PAD row, as Predictor's bucket padding makes
        return m

    def mha_yardstick(x_q, x_kv, mask, w, nheads):
        """torch's one-call MHA (projections + SDPA + out-projection)."""
        wq, bq, wk, bk, wv, bv, wo, bo = w
        t = lambda a: a.t().contiguous().to(bf)
        args = dict(
            use_separate_proj_weight=True, q_proj_weight=t(wq), k_proj_weight=t(wk),
            v_proj_weight=t(wv), in_proj_weight=None,
            in_proj_bias=torch.cat([bq, bk, bv]).to(bf),
            out_proj_weight=t(wo), out_proj_bias=bo.to(bf),
        )
        q, kv = x_q.transpose(0, 1), x_kv.transpose(0, 1)
        kpm = None if mask is None else ~mask
        return lambda: F.multi_head_attention_forward(
            q, kv, kv, q.shape[-1], nheads, bias_k=None, bias_v=None, add_zero_attn=False,
            dropout_p=0.0, training=False, key_padding_mask=kpm, need_weights=False, **args,
        )

    counters = (FA.fused_dense_attention, FA.fused_static_q_attention, A.bshd_flash_attention,
                A.fanout_attention)
    launches_before = [f.launches for f in counters]
    rows = {}

    # K1, BERT site: self-attention, residual + post-LN eps 1e-12.
    x = randn(BQ, SEQ, D)
    m = question_mask(BQ, SEQ)
    w = weights(D, D, D)
    post = ln(D, 1e-12)
    kw = dict(residual=True, post_ln=post)
    flops = 2 * BQ * SEQ * D * D * 4 + 4 * BQ * H * SEQ * SEQ * 64
    rows["bert"] = run_case(
        "K1 BERT site (2048 x 32 tokens)",
        lambda: FA.fused_dense_attention(x, x, m, *w, H, **kw),
        lambda: FA._fused_dense_plain(x, x, m, *w, H, None, None, True, post),
        mha_yardstick(x, x, m, w, H), flops, nbytes(x, m, *w, *post[:2]) + nbytes(x),
    )
    # K1, BTIA img<-txt: q_ln + kv_ln + residual, question mask.
    img = randn(BQ, N_IMG_TOK, D)
    txt = randn(BQ, SEQ, D)
    w = weights(D, D, D)
    li, lt = ln(D, 1e-6), ln(D, 1e-6)
    flops = (2 * BQ * (N_IMG_TOK * 2 + SEQ * 2) * D * D + 4 * BQ * H * N_IMG_TOK * SEQ * 64)
    rows["btia_i2t"] = run_case(
        "K1 BTIA img<-txt (2048 x 50 <- 32)",
        lambda: FA.fused_dense_attention(img, txt, m, *w, H, q_ln=li, kv_ln=lt, residual=True),
        lambda: FA._fused_dense_plain(img, txt, m, *w, H, li, lt, True, None),
        mha_yardstick(img, txt, m, w, H), flops,
        nbytes(img, txt, m, *w, *li[:2], *lt[:2]) + nbytes(img),
    )
    # K1, BTIA txt<-img: unmasked.
    flops = (2 * BQ * (SEQ * 2 + N_IMG_TOK * 2) * D * D + 4 * BQ * H * SEQ * N_IMG_TOK * 64)
    rows["btia_t2i"] = run_case(
        "K1 BTIA txt<-img (2048 x 32 <- 50)",
        lambda: FA.fused_dense_attention(txt, img, None, *w, H, q_ln=lt, kv_ln=li, residual=True),
        lambda: FA._fused_dense_plain(txt, img, None, *w, H, lt, li, True, None),
        mha_yardstick(txt, img, None, w, H), flops,
        nbytes(img, txt, *w, *li[:2], *lt[:2]) + nbytes(txt),
    )
    # K2, AD head: 64 answer queries over 82 fused tokens.
    K, SK = 64, N_IMG_TOK + SEQ
    queries = randn(K, D, std=0.02)
    tokens = randn(BQ, SK, D)
    tmask = torch.cat([torch.ones(BQ, N_IMG_TOK, dtype=torch.bool, device=dev), m], dim=1)
    w = weights(D, D, D)
    lk = ln(D, 1e-6)
    flops = 2 * K * D * D + 2 * BQ * SK * D * 2 * D + 4 * BQ * H * K * SK * 64 + 2 * BQ * K * D * D
    rows["k2"] = run_case(
        "K2 AD head (2048 x 64 queries <- 82)",
        lambda: FA.fused_static_q_attention(queries, tokens, tmask, *w, H, kv_ln=lk, residual=True),
        lambda: FA._static_q_plain(queries, tokens, tmask, *w, H, lk, True),
        mha_yardstick(queries[None].expand(BQ, K, D), tokens, tmask, w, H), flops,
        nbytes(queries, tokens, tmask, *w, *lk[:2]) + BQ * K * D * 2,
    )
    # K2 at head widths 128, 192 and 256: the AD head of a model with
    # num_heads 6, 4 and 3.
    for heads in WIDE_HEADS:
        rows[f"k2_d{D // heads}"] = run_case(
            f"K2 AD head, {heads} heads of {D // heads} (2048 x 64 queries <- 82)",
            lambda: FA.fused_static_q_attention(queries, tokens, tmask, *w, heads, kv_ln=lk, residual=True),
            lambda: FA._static_q_plain(queries, tokens, tmask, *w, heads, lk, True),
            mha_yardstick(queries[None].expand(BQ, K, D), tokens, tmask, w, heads), flops,
            nbytes(queries, tokens, tmask, *w, *lk[:2]) + BQ * K * D * 2,
        )
    # K3, ViT-L/336 self-attention: 16 images x 577 tokens x 16 heads.
    S = 577
    q, k, v = (randn(B_IMG, S, HDv) for _ in range(3))
    split = lambda t: t.view(B_IMG, S, 16, 64).transpose(1, 2)
    flops = 4 * B_IMG * 16 * S * S * 64
    rows["k3"] = run_case(
        "K3 ViT-L attention (16 x 577, 16 heads)",
        lambda: A.bshd_flash_attention(q, k, v, None, 16),
        lambda: A._bshd_flash_plain(q, k, v, None, 16),
        lambda: F.scaled_dot_product_attention(split(q), split(k), split(v)),
        flops, nbytes(q, k, v) + nbytes(q), iters=20,
    )
    # K4 at the serve step's shapes under disable_fused(): each K1/K2 site's
    # unfused road sends its short attention (2048 rows, 12 heads of 64) there.
    for name, sq, sk, masked in K4_SERVE_SHAPES:
        rows[name] = k4_case(torch, name, BQ, sq, sk, masked, H, randn, question_mask, iters=10)
    rows.update(check_training_kernels(torch, dev, randn, weights, ln, question_mask, mha_yardstick))
    for f, before in zip(counters, launches_before):
        f.launches = before  # comparison launches are not main-path launches
    return rows


def k4_case(torch, name, B, sq, sk, masked, heads, randn, question_mask, iters):
    """K4 (fanout_attention) at B x sq <- sk over a 768-wide model of
    `heads` heads, against its twin, timed beside SDPA and the bound; a
    fully masked row must be exactly 0. Where two batch rows share a tile
    (sq <= 32), the kernel with one batch row a tile is timed too."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import attention as A

    D = 768
    q, k, v = randn(B, sq, D), randn(B, sk, D), randn(B, sk, D)
    cm = question_mask(B, sk).float() if masked else torch.ones(B, sk, device=q.device)
    split = lambda t: t.view(B, t.shape[1], heads, D // heads).transpose(1, 2)
    keep = (cm > 0)[:, None, None, :]
    row = run_case(
        f"K4 fan-out attention ({B} x {sq} <- {sk}, {heads} heads of {D // heads})",
        lambda: A.fanout_attention(q, k, v, cm, heads),
        lambda: A._fanout_plain(q, k, v, cm, heads),
        lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=keep),
        4 * B * sq * sk * D, nbytes(q, k, v, cm) + nbytes(q), iters=iters,
    )
    row["plan"] = A.short_plan([(B, heads, sq, sk)], D // heads)
    if row["plan"][1] > 1:
        row["ms_one_row_a_tile"] = cuda_time_ms(lambda: A._fanout_cuda(q, k, v, cm, heads, pack=False), iters)
        log(f"    one batch row a tile: {row['ms_one_row_a_tile']:.4f} ms (packed {row['plan'][1]} a tile: "
            f"{row['ms']:.4f})")
    if masked and bool(A.fanout_attention(q, k, v, cm, heads)[-1].any()):
        raise AssertionError(f"{name}: a fully masked row is not 0")
    return row


def check_training_kernels(torch, dev, randn, weights, ln, question_mask, mha_yardstick):
    """Phase 2, training shapes: K1 at the vqa_med_full sites, K4 at its
    three shapes (the backward recompute of those sites), and the backward
    pass of each autograd Function against autograd through its twin."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import fused_attn as FA

    D, H, B = 768, 12, B_TRAIN
    rows = {}
    txt = randn(B, SEQ, D)
    img = randn(B, N_VIT_B, D)
    m = question_mask(B, SEQ)
    w = weights(D, D, D)
    li, lt = ln(D, 1e-6), ln(D, 1e-6)
    proj = lambda sq, sk: 2 * B * (2 * sq + 2 * sk) * D * D + 4 * B * H * sq * sk * 64
    # Under train-time dropout BERT's site is plain and BTIA's sites keep
    # their pre-LNs but not the residual.
    rows["med_bert"] = run_case(
        "K1 BERT train site (64 x 32)",
        lambda: FA.fused_dense_attention(txt, txt, m, *w, H),
        lambda: FA._fused_dense_plain(txt, txt, m, *w, H, None, None, False, None),
        mha_yardstick(txt, txt, m, w, H), proj(SEQ, SEQ), nbytes(txt, m, *w) + nbytes(txt),
    )
    rows["med_i2t"] = run_case(
        "K1 BTIA img<-txt train site (64 x 197 <- 32)",
        lambda: FA.fused_dense_attention(img, txt, m, *w, H, q_ln=li, kv_ln=lt),
        lambda: FA._fused_dense_plain(img, txt, m, *w, H, li, lt, False, None),
        mha_yardstick(img, txt, m, w, H), proj(N_VIT_B, SEQ), nbytes(img, txt, m, *w, *li[:2], *lt[:2]) + nbytes(img),
    )
    rows["med_t2i"] = run_case(
        "K1 BTIA txt<-img train site (64 x 32 <- 197)",
        lambda: FA.fused_dense_attention(txt, img, None, *w, H, q_ln=lt, kv_ln=li),
        lambda: FA._fused_dense_plain(txt, img, None, *w, H, lt, li, False, None),
        mha_yardstick(txt, img, None, w, H), proj(SEQ, N_VIT_B), nbytes(img, txt, *w, *li[:2], *lt[:2]) + nbytes(txt),
    )
    # Head widths 128, 192 and 256: the BTIA sites of vqa_med_full with
    # model.num_heads 6, 4 and 3, on the whole-tile core (BERT-shaped
    # 32 x 32) and the tiled one.
    for heads in WIDE_HEADS:
        hw = D // heads
        rows[f"med_bert_d{hw}"] = run_case(
            f"K1 train site, {heads} heads of {hw} (64 x 32)",
            lambda: FA.fused_dense_attention(txt, txt, m, *w, heads),
            lambda: FA._fused_dense_plain(txt, txt, m, *w, heads, None, None, False, None),
            mha_yardstick(txt, txt, m, w, heads), proj(SEQ, SEQ), nbytes(txt, m, *w) + nbytes(txt),
        )
        rows[f"med_i2t_d{hw}"] = run_case(
            f"K1 BTIA img<-txt train site, {heads} heads of {hw} (64 x 197 <- 32)",
            lambda: FA.fused_dense_attention(img, txt, m, *w, heads, q_ln=li, kv_ln=lt),
            lambda: FA._fused_dense_plain(img, txt, m, *w, heads, li, lt, False, None),
            mha_yardstick(img, txt, m, w, heads), proj(N_VIT_B, SEQ),
            nbytes(img, txt, m, *w, *li[:2], *lt[:2]) + nbytes(img),
        )

    for name, sq, sk, masked, heads in (("k4_bert", SEQ, SEQ, True, H), ("k4_i2t", N_VIT_B, SEQ, True, H),
                                        ("k4_t2i", SEQ, N_VIT_B, False, H),
                                        *((f"k4_i2t_d{D // h}", N_VIT_B, SEQ, True, h) for h in WIDE_HEADS)):
        rows[name] = k4_case(torch, name, B, sq, sk, masked, heads, randn, question_mask, iters=20)

    def sdpa(q, k, v, cm, heads=H):
        split = lambda t: t.view(B, t.shape[1], heads, D // heads).transpose(1, 2)
        keep = (cm > 0)[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=keep)

    # K3 at the training shapes: ViT-B/16 self-attention and the AD head's
    # 2048 answer queries over 197 + 32 fused tokens, at 12 heads of 64 and
    # (model.num_heads 6, 4, 3) 6 of 128, 4 of 192 and 3 of 256.
    for name, sq, sk, masked, heads in (("k3_vitb", N_VIT_B, N_VIT_B, False, H),
                                        ("k3_head", 2048, N_VIT_B + SEQ, True, H),
                                        *((f"k3_head_d{D // h}", 2048, N_VIT_B + SEQ, True, h)
                                          for h in WIDE_HEADS)):
        q, k, v = randn(B, sq, D), randn(B, sk, D), randn(B, sk, D)
        km = (torch.cat([torch.ones(B, N_VIT_B, dtype=torch.bool, device=dev), question_mask(B, SEQ)], 1)
              if masked else None)
        cm = torch.ones(B, sk, device=dev) if km is None else km.float()
        rows[name] = run_case(
            f"K3 attention (64 x {sq} <- {sk}, {heads} heads of {D // heads})",
            lambda: A.bshd_flash_attention(q, k, v, km, heads),
            lambda: A._bshd_flash_plain(q, k, v, km, heads),
            sdpa(q, k, v, cm, heads), 4 * B * sq * sk * D, nbytes(q, k, v, km) + nbytes(q), iters=10,
        )

    # Backward passes: each Function's backward (the reference's vjp policy)
    # against autograd through its plain twin, in bf16 on the card.
    q2 = randn(64, D, std=0.02)  # 64 answer queries
    tok = randn(B, 82, D)
    tmask = torch.cat([torch.ones(B, 50, dtype=torch.bool, device=dev), question_mask(B, SEQ)], 1)
    vq, vk, vv = (randn(B, N_VIT_B, D) for _ in range(3))
    cm = question_mask(B, SEQ).float()
    k4q, k4k, k4v = randn(B, N_VIT_B, D), randn(B, SEQ, D), randn(B, SEQ, D)
    cases = {
        # name: (Function entry, twin, inputs, index of bk (gradient 0 in exact arithmetic))
        "K1": (lambda a, b, *w_: FA.fused_dense_attention(a, b, m, *w_, H, q_ln=li, kv_ln=lt),
               lambda a, b, *w_: FA._fused_dense_plain(a, b, m, *w_, H, li, lt, False, None),
               [img, txt, *w], 5),
        "K2": (lambda a, b, *w_: FA.fused_static_q_attention(a, b, tmask, *w_, H, kv_ln=lt, residual=True),
               lambda a, b, *w_: FA._static_q_plain(a, b, tmask, *w_, H, lt, True),
               [q2, tok, *w], 5),
        "K3": (lambda a, b, c: A.bshd_flash_attention(a, b, c, None, H),
               lambda a, b, c: A._bshd_flash_plain(a, b, c, None, H), [vq, vk, vv], None),
        "K4": (lambda a, b, c: A.fanout_attention(a, b, c, cm, H),
               lambda a, b, c: A._fanout_plain(a, b, c, cm, H), [k4q, k4k, k4v], None),
    }
    g = torch.Generator(device=dev).manual_seed(1)
    for name, (fn, twin, inputs, bk) in cases.items():
        rows[f"{name}_backward"] = check_backward(torch, name, fn, twin, inputs, g, bk)
    return rows


def check_backward(torch, name, fn, twin, inputs, gen, bk=None, tol_div=32):
    """A Function's backward (the reference's vjp policy) against autograd
    through its plain twin, on the card, with one random cotangent per
    output; each gradient within its largest magnitude / tol_div. bk is the
    index of a key-projection bias, whose true gradient is 0 (a constant
    shift of a score row): both sides give rounding noise there, held to
    the value projection bias's tolerance (index bk + 2)."""
    leaves = lambda: [t.detach().clone().requires_grad_(True) for t in inputs]
    a, b = leaves(), leaves()
    out = fn(*a)
    outs = out if isinstance(out, tuple) else (out,)
    cot = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype) for o in outs]
    got = torch.autograd.grad(outs, a, cot)
    ref_out = twin(*b)
    want = torch.autograd.grad(ref_out if isinstance(ref_out, tuple) else (ref_out,), b, cot)
    torch.cuda.synchronize()
    errs, tols = [], []
    for i, (x, y) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(x.float()).all()):
            raise AssertionError(f"{name} backward: gradient {i} is not finite")
        ref = want[i + 2] if i == bk else y
        errs.append((x.float() - y.float()).abs().max().item())
        tols.append(ref.float().abs().max().item() / tol_div)
    log(f"  {name} backward vs autograd through its twin: max abs err / tol per input "
        + ", ".join(f"{e:.3g}/{t:.3g}" for e, t in zip(errs, tols)))
    if any(e > t for e, t in zip(errs, tols)):
        raise AssertionError(f"{name} backward disagrees with autograd through its twin")
    return {"max_abs_err": errs, "tol": tols}


def bf16_steps(torch, x):
    """One bf16 step (2^-7 of the leading binade) at each element's
    magnitude."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


def check_gemm(torch, dev):
    """Phase 2, the projection GEMM of K1/K2 (``gemm_bias``) alone at each
    serve and train shape (GEMM_SITES, GEMM_TRAIN_SITES), against
    ``_proj_plain`` on the same inputs:
    each element within one bf16 step at its magnitude (the sums are taken
    in another order, so a rounding may flip), plus, with the residual, one
    more step of the projection's magnitude (the flipped projection is
    rounded again after the add), and a floor of 1e-6 of the largest value.
    Timed beside ``torch.addmm`` (the same function in one PyTorch call, the
    yardstick only) and the bound."""
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.ops import gemm as G

    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    rows = {}
    for name, M, K, N, rr, per_step in GEMM_SITES + GEMM_TRAIN_SITES:
        a = torch.randn(M, K, generator=g, device=dev).to(bf)
        w = (torch.randn(K, N, generator=g, device=dev) * K**-0.5).to(bf)
        b = torch.randn(N, generator=g, device=dev) * 0.02
        r = torch.randn(rr, N, generator=g, device=dev).to(bf) if rr else None
        kernel = lambda: G.gemm_bias(a, w, b, r, rr)
        out = kernel()
        torch.cuda.synchronize()
        y0 = FA._proj_plain(a, w, b, bf)
        ref = y0 if r is None else (y0.float() + r.float().repeat(M // rr, 1)).to(bf)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"GEMM {name}: kernel output is not finite")
        diff = (out.float() - ref.float()).abs()
        tol = bf16_steps(torch, ref) + (0 if r is None else bf16_steps(torch, y0)) + 1e-6 * ref.float().abs().max()
        bad = int((diff > tol).sum())
        b_bf = b.to(bf)
        row = {
            "shape": [M, K, N], "resid_rows": rr, "launches_per_step": per_step,
            "max_abs_err": diff.max().item(), "elements_off": bad,
            "ms": cuda_time_ms(kernel, 20),
            "plain_ms": cuda_time_ms(lambda: FA._proj_plain(a, w, b, bf), 3),
            "library_ms": cuda_time_ms(lambda: torch.addmm(b_bf, a, w), 20),
            "library": "torch.addmm (matmul + bias)",
        }
        row["bound_ms"], row["bound_by"] = bound_ms(2 * M * K * N, nbytes(a, w, b, r) + M * N * 2)
        row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
        log(f"  GEMM {name} ({M} x {K} -> {N}{f', residual every {rr} rows' if rr else ''}): "
            f"err {row['max_abs_err']:.4g}, {bad} elements beyond the limit; kernel {row['ms']:.4f} ms "
            f"({row['tflops']:.0f} TFLOP/s), plain {row['plain_ms']:.4f} ms, addmm {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if bad:
            raise AssertionError(f"GEMM {name}: {bad} elements disagree with _proj_plain")
        rows[name] = row
        del a, w, b, r, out, y0, ref, diff, tol
    torch.cuda.empty_cache()
    per_step = {}
    for path, sites in (("serve_step", GEMM_SITES), ("train_step", GEMM_TRAIN_SITES)):
        got = [rows[site[0]] for site in sites]
        per_step[path] = {k: sum(x[k] * x["launches_per_step"] for x in got) for k in ("ms", "library_ms", "bound_ms")}
        per_step[path]["launches"] = sum(x["launches_per_step"] for x in got)
        log(f"  GEMM per {path.replace('_', ' ')} ({per_step[path]['launches']} launches): kernel "
            f"{per_step[path]['ms']:.3f} ms, addmm {per_step[path]['library_ms']:.3f} ms, "
            f"bound {per_step[path]['bound_ms']:.3f} ms")
    return rows, per_step


def check_mlp_gemm(torch, dev):
    """Phase 2, the projection GEMM with Dense's epilogue (``gemm_bias``
    with the f32 bias, and at fc1 the tanh-GELU, in its epilogue) at the
    bf16 serve step's Mlp products (MLP_SITES), against an f32 reference of
    the same function on the same bf16 operands: each element within one
    bf16 step at its magnitude, and a floor of 1e-6 of the largest value
    for every 768 of K (the tensor cores' accumulation error grows with K).
    Timed beside ``torch.addmm`` (the product and its bias: the yardstick),
    ``addmm`` then ``F.gelu`` at fc1, the chain ``Dense`` ran before (the
    f32 weight and bias cast to bf16, ``matmul``, the bias add, ``F.gelu``)
    and the bound."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import gemm as G

    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    rows = {}
    for name, M, K, N, act, per_step in MLP_SITES:
        a = torch.randn(M, K, generator=g, device=dev).to(bf)
        w32 = torch.randn(K, N, generator=g, device=dev) * K**-0.5
        b = torch.randn(N, generator=g, device=dev) * 0.02
        w, b_bf = w32.to(bf), b.to(bf)
        kernel = lambda: G.gemm_bias(a, w, b, act=act)
        gelu = (lambda y: F.gelu(y, approximate="tanh")) if act else (lambda y: y)
        out = kernel().float()
        ref = gelu(a.float() @ w.float() + b)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"Mlp GEMM {name}: kernel output is not finite")
        diff = (out - ref).abs()
        bad = int((diff > bf16_steps(torch, ref) + 1e-6 * max(1.0, K / 768) * ref.abs().max()).sum())
        row = {
            "shape": [M, K, N], "act": act, "launches_per_step": per_step, "tile": G.gemm_plan(M, N),
            "max_abs_err": diff.max().item(), "elements_off": bad,
            "ms": cuda_time_ms(kernel, 20),
            "library_ms": cuda_time_ms(lambda: torch.addmm(b_bf, a, w), 20),
            "library": "torch.addmm (matmul + bias)",
            "library_act_ms": cuda_time_ms(lambda: gelu(torch.addmm(b_bf, a, w)), 20),
            "chain_ms": cuda_time_ms(lambda: gelu(torch.matmul(a, w32.to(bf)) + b.to(bf)), 20),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(2 * M * K * N, nbytes(a, w, b) + M * N * 2)
        row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
        log(f"  Mlp GEMM {name} ({M} x {K} -> {N}{', GELU' if act else ''}): err {row['max_abs_err']:.4g}, "
            f"{bad} elements beyond the limit; kernel {row['ms']:.4f} ms ({row['tflops']:.0f} TFLOP/s, "
            f"{row['ms'] / row['library_ms']:.3f} of addmm), addmm {row['library_ms']:.4f} ms, addmm"
            f"{' + GELU' if act else ''} {row['library_act_ms']:.4f} ms, the earlier chain {row['chain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if bad:
            raise AssertionError(f"Mlp GEMM {name}: {bad} elements disagree with the f32 reference")
        rows[name] = row
        del a, w32, b, w, b_bf, out, ref, diff
    torch.cuda.empty_cache()
    per_step = {k: sum(x[k] * x["launches_per_step"] for x in rows.values())
                for k in ("ms", "library_ms", "library_act_ms", "chain_ms", "bound_ms")}
    per_step["launches"] = sum(x["launches_per_step"] for x in rows.values())
    log(f"  Mlp GEMMs per serve step ({per_step['launches']} launches): kernel {per_step['ms']:.3f} ms, addmm "
        f"{per_step['library_ms']:.3f} ms, addmm (+ GELU at fc1) {per_step['library_act_ms']:.3f} ms, the earlier "
        f"chain {per_step['chain_ms']:.3f} ms, bound {per_step['bound_ms']:.3f} ms")
    return rows, per_step


# One MoE layer of kimivl-fanout-backlog (streaming_kimivl): tokens of a
# 16 x 128 launch (11.3 real ids a question on average), routed experts,
# shared experts, experts a token, hidden and expert widths.
MOE_SHAPE = (23000, 64, 2, 6, 2048, 1408)
MOE_LAUNCHES_PER_LAYER = 2  # the SwiGLU product and the down product


def check_moe_gemm(torch, dev):
    """Phase 2, the grouped expert GEMM at one MoE layer of the serve cell
    (MOE_SHAPE), its rows routed unevenly (each expert's share lognormal):
    each product through ``grouped_gemm`` against the twin on the same bf16
    operands, every row of a block in use within one bf16 step plus 2e-6 of
    the largest value for every 768 of K (the tensor cores' accumulation
    order, SiLU's fast exponent and divide); each timed beside the twin, a
    per-expert bf16 ``torch.mm`` loop with SiLU * up or the routing weight
    (the yardstick) and the bound (operations, or every group's weights and
    the rows in and out once). Then ``models/mla_moe.py::MoE`` at the
    published widths on the same tokens with ``grouped_gemm.launches`` set
    to 0 just before and read just after. Returns (rows, launches)."""
    import torch.nn.functional as F

    from btia_tpu_torch.models.mla_moe import LMSpec, MoE
    from btia_tpu_torch.ops import moe as M

    T, E, S, k, D, I = MOE_SHAPE
    G, bf = E + S, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(22)
    share = torch.exp(0.5 * torch.randn(E, generator=g, device=dev))
    idx = torch.multinomial(share.expand(T, E), k, generator=g)
    eid = torch.cat([idx, torch.arange(E, G, device=dev).expand(T, S)], 1)
    wt = torch.cat([torch.rand(T, k, generator=g, device=dev), torch.ones(T, S, device=dev)], 1)
    p = M.plan(eid, G)
    x = torch.randn(T, D, generator=g, device=dev).to(bf)
    a, rw = M.gather(x, p), M.scatter_weights(wt, p)
    gu = (torch.randn(G, D, 2 * I, generator=g, device=dev) * D**-0.5).to(bf)
    dn = (torch.randn(G, I, D, generator=g, device=dev) * I**-0.5).to(bf)
    h = M.grouped_gemm(a, gu, p, "swiglu")
    counts = p.counts.tolist()
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + -(-c // M.BLOCK) * M.BLOCK)
    n_rows, used = T * (k + S), int(p.used[0]) * M.BLOCK
    load = max(counts[:E]) / (sum(counts[:E]) / E)

    def loop(act, inp, w):
        out = torch.empty(p.rows, I if act else D, dtype=bf, device=dev)
        for e, c in enumerate(counts):
            r = slice(starts[e], starts[e] + c)
            out[r] = (F.silu(torch.mm(inp[r], w[e, :, :I])) * torch.mm(inp[r], w[e, :, I:]) if act
                      else torch.mm(inp[r], w[e]) * rw[r, None])
        return out

    launches_before = M.grouped_gemm.launches
    rows = {}
    for name, act, inp, w, scale, K, N in (("swiglu", "swiglu", a, gu, None, D, 2 * I),
                                           ("down", None, h, dn, rw, I, D)):
        got = M.grouped_gemm(inp, w, p, act, scale)[:used].float()
        want = M._grouped_plain(inp, w, p, act, scale)[:used].float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"grouped GEMM {name}: kernel output is not finite")
        diff = (got - want).abs()
        bad = int((diff > bf16_steps(torch, want) + 2e-6 * max(1.0, K / 768) * want.abs().max()).sum())
        row = {
            "shape": [n_rows, K, N], "groups": G, "load_max_over_mean": load, "launches_per_layer": 1,
            "max_abs_err": diff.max().item(), "elements_off": bad,
            "ms": cuda_time_ms(lambda: M.grouped_gemm(inp, w, p, act, scale), 10),
            "plain_ms": cuda_time_ms(lambda: M._grouped_plain(inp, w, p, act, scale), 3, warmup=1),
            "library_ms": cuda_time_ms(lambda: loop(act, inp, w), 10),
            "library": "per-expert bf16 torch.mm loop" + (" with SiLU * up" if act else " times the weight"),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * n_rows * K * N, 2.0 * (G * K * N + n_rows * (K + (N // 2 if act else N))))
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
        log(f"  grouped GEMM {name} ({n_rows} rows over {G} groups, load max/mean {load:.2f}, {K} -> {N}): err "
            f"{row['max_abs_err']:.4g}, {bad} elements beyond the limit; kernel {row['ms']:.4f} ms "
            f"({row['roofline_pct']:.1f} % of its bound), twin {row['plain_ms']:.4f} ms, torch.mm loop "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if bad:
            raise AssertionError(f"grouped GEMM {name}: {bad} elements disagree with the twin")
        rows[name] = row
        del got, want, diff
    M.grouped_gemm.launches = launches_before  # comparison launches are not main-path launches
    layer = MoE(LMSpec(), bf, dev)
    with torch.no_grad():
        layer.router.kernel.copy_((torch.randn(D, E, generator=g, device=dev) * D**-0.5).to(bf))
        layer.correction_bias.zero_()
        layer.experts.gate_up.copy_(gu)
        layer.experts.down.copy_(dn)
    with torch.inference_mode():
        layer(x)
        torch.cuda.synchronize()
        M.grouped_gemm.launches = 0
        y = layer(x)
        torch.cuda.synchronize()
        launches = M.grouped_gemm.launches
    M.grouped_gemm.launches = launches_before + launches
    if launches != MOE_LAUNCHES_PER_LAYER or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError(f"a MoE layer launched the grouped GEMM {launches} times (want "
                             f"{MOE_LAUNCHES_PER_LAYER}), its output finite: {bool(torch.isfinite(y.float()).all())}")
    log(f"  MoE layer ({T} tokens): grouped GEMM launches {launches}; both products {rows['swiglu']['ms'] + rows['down']['ms']:.4f} ms, "
        f"the torch.mm loops {rows['swiglu']['library_ms'] + rows['down']['library_ms']:.4f} ms, bound "
        f"{rows['swiglu']['bound_ms'] + rows['down']['bound_ms']:.4f} ms")
    del layer, a, h, gu, dn, x, y
    torch.cuda.empty_cache()
    return rows, launches


# The MLA attention core at kimivl-fanout-backlog's shapes: questions a
# launch (16 x 128), S, heads, q_nope, q_pe and v widths; real ids a
# question 7-16 (WordPiece lengths), lengths 1 and S mixed in.
MLA_SHAPE = (2048, 32, 16, 128, 64, 128)
MLA_LAUNCHES_PER_LAYER = 1  # 27 a forward of the 27-layer language model


def mla_inputs(torch, dev, seed: int):
    """One layer's core operands at MLA_SHAPE: q, [k_nope | v], q_pe, k_pe
    (scores of scale ~1), the real rows' flat indices and the (B, S) mask,
    one question with a padding id inside."""
    B, S, H, dn, dr, dv = MLA_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(7, 17, (B,), generator=g, device=dev)
    lengths[:4] = torch.tensor([1, S, 1, S], device=dev)
    mask = torch.arange(S, device=dev)[None] < lengths[:, None]
    mask[5, 3] = False
    index = torch.nonzero(mask.reshape(-1)).squeeze(1)
    T, bf = index.numel(), torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(bf)
    return rnd(T, H, dn + dr), rnd(T, H, dn + dv), rnd(T, H, dr), rnd(T, 1, dr), index, mask


def mla_entry(torch, lib, q, kv, q_pe, k_pe, index, mask):
    """(launch, o): the C entry ``btia_mla_attn`` of `lib` on the operands
    as ``ops/mla.py::_mla_cuda`` hands them over; launch() returns its code."""
    import ctypes

    from btia_tpu_torch.ops import _native

    T, H, _ = q.shape
    dr = q_pe.shape[-1]
    dn = q.shape[-1] - dr
    dv = kv.shape[-1] - dn
    k2 = k_pe.reshape(T, dr)
    o = torch.empty(T, H * dv, dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 9)(q.stride(0), q.stride(1), q_pe.stride(0), q_pe.stride(1), kv.stride(0),
                                      kv.stride(1), k2.stride(0), H * dv, dv)
    stream = _native.stream(q)
    args = (q.data_ptr(), q_pe.data_ptr(), kv.data_ptr(), k2.data_ptr(), o.data_ptr(), index.data_ptr(), strides,
            T, H, mask.shape[1], dn, dr, dv, (dn + dr) ** -0.5, stream)
    return (lambda: lib.btia_mla_attn(*args)), o


def mla_bytes(q, kv, q_pe, k_pe, index) -> int:
    """The core's operands once: q_nope, q_pe, [k_nope | v], k_pe and the
    indices read, o written."""
    T, H, _ = q.shape
    dr = q_pe.shape[-1]
    dn = q.shape[-1] - dr
    dv = kv.shape[-1] - dn
    return 2 * T * (H * dn + H * dr + H * (dn + dv) + dr + H * dv) + 8 * T


def check_mla_attn(torch, dev):
    """Phase 2, the MLA attention core (``ops/mla.py::mla_attention``,
    ``csrc/mla_attn.cu``) at one layer of the kimivl serve cell (MLA_SHAPE):
    against the twin (``_mla_plain``, the grid code) on the same bf16
    operands, every element within one bf16 step plus 2^-8 of the largest
    |v| (the scores' f32 sums in another order can flip a probability's
    bf16 rounding), timed through the C entry alone, the wrapper and the
    twin beside the bytes bound; then ``models/mla_moe.py::MLA`` at the
    published widths on the same rows with the counter set to 0 just
    before and read just after. Returns (row, launches)."""
    from btia_tpu_torch.core.dtypes import BF16_POLICY
    from btia_tpu_torch.models.mla_moe import MLA, LMSpec
    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.ops import mla as A

    B, S, H, dn, dr, dv = MLA_SHAPE
    q, kv, q_pe, k_pe, index, mask = mla_inputs(torch, dev, 23)
    T = index.numel()
    before = A.mla_attention.launches
    got = A.mla_attention(q, kv, q_pe, k_pe, index, mask).float()
    want = A._mla_plain(q, kv, q_pe, k_pe, index, mask).float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("mla attention: kernel output is not finite")
    diff = (got - want).abs()
    bad = int((diff > bf16_steps(torch, want) + 2.0**-8 * kv[..., dn:].float().abs().max()).sum())
    launch, _ = mla_entry(torch, _native.lib(), q, kv, q_pe, k_pe, index, mask)
    row = {
        "shape": [T, H, dn, dr, dv], "questions": B, "S": S, "max_abs_err": diff.max().item(), "elements_off": bad,
        "beyond_one_step": int((diff > bf16_steps(torch, want)).sum()),
        "ms": cuda_time_ms(lambda: A.mla_attention(q, kv, q_pe, k_pe, index, mask), 20),
        "entry_ms": cuda_time_ms(launch, 20),
        "plain_ms": cuda_time_ms(lambda: A._mla_plain(q, kv, q_pe, k_pe, index, mask), 3, warmup=1),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(2.0 * T * H * 96 * (dn + dr + dv), mla_bytes(q, kv, q_pe, k_pe,
                                                                                                   index))
    row["roofline_pct"] = 100.0 * row["bound_ms"] / row["entry_ms"]
    log(f"  MLA attention core ({B} questions, {T} real tokens, {H} heads, {dn} + {dr} | {dv}): err "
        f"{row['max_abs_err']:.4g}, {row['beyond_one_step']} elements beyond one bf16 step, {bad} beyond the limit; "
        f"C entry {row['entry_ms']:.4f} ms ({row['roofline_pct']:.1f} % of its bound), wrapper {row['ms']:.4f} ms, "
        f"twin {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if bad:
        raise AssertionError(f"mla attention: {bad} elements disagree with the twin")
    A.mla_attention.launches = before  # comparison launches are not main-path launches
    layer = MLA(LMSpec(), BF16_POLICY, dev)
    g = torch.Generator(device=dev).manual_seed(24)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * p.shape[0] ** -0.5 if name.endswith("kernel")
                    else torch.ones_like(p) if name.endswith("scale") else torch.zeros_like(p))
    h = torch.randn(T, LMSpec().dim, generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        layer(h, index, index % S, mask)
        torch.cuda.synchronize()
        A.mla_attention.launches = 0
        y = layer(h, index, index % S, mask)
        torch.cuda.synchronize()
        launches = A.mla_attention.launches
    A.mla_attention.launches = before + launches
    if launches != MLA_LAUNCHES_PER_LAYER or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError(f"an MLA layer launched the attention kernel {launches} times (want "
                             f"{MLA_LAUNCHES_PER_LAYER}), its output finite: {bool(torch.isfinite(y.float()).all())}")
    log(f"  MLA layer ({T} tokens): attention kernel launches {launches}")
    del layer, q, kv, q_pe, k_pe, got, want, diff, h, y
    torch.cuda.empty_cache()
    return row, launches


# Phase 2, the shapes a persistent schedule can get wrong: K3 and K5 at
# work-item counts just under, at and over one and two items an SM (132 and
# 264 on an H100), at one row and one key, at one head of ViT-L, and with key
# counts that leave the K/V ring at another stage and parity after every
# item: (B, Sq, Sk, heads), items = ceil(Sq / 128) * heads * B; each at head
# widths 64 and 128 (K5: 64 and 96), masked where the index is odd.
EDGE_ATTN = ((1, 1, 1, 1), (1, 577, 577, 1), (131, 100, 300, 1), (66, 128, 300, 2), (133, 64, 229, 1),
             (263, 50, 130, 1), (132, 100, 65, 2), (265, 20, 577, 1))
# The projection GEMM at M 1, 127 and 129 and at tile counts around 132 and
# 264 (N 256: 128 x 256 tiles; N 128: 128 x 128), with no residual, a
# residual of every row or of 64 rows (loaded by TMA) and of 127 or 3 rows
# (read by the consumers), K 200 and 136 for a K tail: (name, M, K, N,
# rows the residual repeats over).
EDGE_GEMM = (("m1", 1, 768, 768, 0), ("m127_res127", 127, 768, 768, 127), ("m129", 129, 768, 768, 0),
             ("m129_res64", 129, 768, 768, 64), ("tiles131_k200", 131 * 128, 200, 256, 0),
             ("tiles132_res_all", 132 * 128, 768, 256, 132 * 128), ("tiles133_res64", 133 * 128, 768, 256, 64),
             ("tiles263_res3_k136", 263 * 128, 136, 256, 3), ("tiles264", 264 * 128, 768, 256, 0),
             ("tiles265_res_all", 265 * 128, 768, 256, 265 * 128), ("tiles264_n128", 264 * 128, 768, 128, 0))


def check_persistent_edges(torch, dev):
    """Phase 2: K3, K5 and the projection GEMM at EDGE_ATTN and EDGE_GEMM
    against their plain twins, with phase 2's tolerances (attention
    max|twin| / 32; the GEMM one bf16 step an element, see ``check_gemm``).
    Returns {"k3": ..., "k5": ..., "gemm": ...}; the comparison launches are
    not main-path launches."""
    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.ops import gemm as G

    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(bf)
    counters = (A.bshd_flash_attention, A.mha_bhsd_attention)
    before = [f.launches for f in counters]
    out = {"k3": {}, "k5": {}, "gemm": {}}

    def hold(group, name, got, ref, plan):
        got, ref = got.float(), ref.float()
        err, tol = (got - ref).abs().max().item(), ref.abs().max().item() / 32
        out[group][name] = {"max_abs_err": err, "tol": tol, "items_grid": list(plan)}
        if not (bool(torch.isfinite(got).all()) and err <= tol):
            raise AssertionError(f"{group} {name}: err {err} > {tol} or not finite")

    for i, (B, Sq, Sk, H) in enumerate(EDGE_ATTN):
        mask = None
        if i % 2:
            mask = torch.rand(B, Sk, generator=g, device=dev) > 0.3
            mask[:, 0] = True
        for D in (64, 128):
            q, k, v = randn(B, Sq, H * D), randn(B, Sk, H * D), randn(B, Sk, H * D)
            hold("k3", f"B{B}_Sq{Sq}_Sk{Sk}_H{H}_D{D}", A.bshd_flash_attention(q, k, v, mask, H),
                 A._bshd_flash_plain(q, k, v, mask, H), A.flash_plan(B, H, Sq, D))
        for D in (64, 96):
            q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
            hold("k5", f"B{B}_Sq{Sq}_Sk{Sk}_H{H}_D{D}", A.mha_bhsd_attention(q, k, v, mask),
                 A._mha_bhsd_plain(q, k, v, mask), A.flash_plan(B, H, Sq, D))
        del q, k, v
    for f, n in zip(counters, before):
        f.launches = n
    for name, M, K, N, rr in EDGE_GEMM:
        a = randn(M, K)
        w = (torch.randn(K, N, generator=g, device=dev) * K**-0.5).to(bf)
        b = torch.randn(N, generator=g, device=dev) * 0.02
        r = randn(rr, N) if rr else None
        got = G.gemm_bias(a, w, b, r, rr)
        y0 = FA._proj_plain(a, w, b, bf)
        ref = y0 if r is None else (y0.float() + r.float().repeat(-(-M // rr), 1)[:M]).to(bf)
        diff = (got.float() - ref.float()).abs()
        tol = bf16_steps(torch, ref) + (0 if r is None else bf16_steps(torch, y0)) + 1e-6 * ref.float().abs().max()
        bad = int((diff > tol).sum())
        tile, grid = G.gemm_plan(M, N)
        bm, bn = G.GEMM_TILES[tile]
        out["gemm"][name] = {"shape": [M, K, N], "resid_rows": rr, "tile": [bm, bn], "grid": grid,
                             "tiles": -(-M // bm) * -(-N // bn), "max_abs_err": diff.max().item(),
                             "elements_off": bad}
        if bad or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"GEMM edge {name}: {bad} elements disagree with _proj_plain")
    log("  persistent-schedule edges, max abs err / tol: "
        + ", ".join(f"K3 {n} {x['max_abs_err']:.3g}/{x['tol']:.3g}" for n, x in out["k3"].items()) + "; "
        + ", ".join(f"K5 {n} {x['max_abs_err']:.3g}/{x['tol']:.3g}" for n, x in out["k5"].items()) + "; GEMM "
        + ", ".join(f"{n} ({x['tiles']} tiles of {x['tile']}, grid {x['grid']}) {x['max_abs_err']:.3g}"
                    for n, x in out["gemm"].items()))
    torch.cuda.empty_cache()
    return out


def check_core(torch, dev):
    """Phase 2, K1/K2's attention core alone (CORE_SITES): the C entry of the
    short-sequence kernel bound by ``_core_launcher`` on the operands the
    chain hands it (q rows in the log2 domain, or K2's one query table; the
    [k|v] GEMM output; the bool key mask, its last row all PAD), held
    against ``attend_log2`` within max|ref|/32 (the twins' tolerance), the
    all-PAD row exactly 0, and timed (CUDA events) beside the plain twin,
    SDPA on the same buffers' head views (the yardstick only) and the bytes
    bound. Direct C calls: no launch counter moves."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import fused_attn as FA

    g = torch.Generator(device=dev).manual_seed(9)
    bf, HD = torch.bfloat16, 768
    rows = {}
    for name, B, sq, sk, heads, masked, shared, per_serve, per_train in CORE_SITES:
        D = HD // heads
        # Scores of a few units in the log2 domain, as the folded projection gives.
        q = (torch.randn(sq if shared else B * sq, HD, generator=g, device=dev) * D**-0.25).to(bf)
        kv = (torch.randn(B * sk, 2 * HD, generator=g, device=dev) * D**-0.25).to(bf)
        mask = None
        if masked:
            mask = _question_mask(torch, dev, g, B, min(sk, SEQ))
            if sk > SEQ:  # K2's image tokens, then the question
                mask = torch.cat([torch.ones(B, sk - SEQ, dtype=torch.bool, device=dev), mask], 1)
                mask[-1] = False
        launch, out = FA._core_launcher(q, kv, mask, B, sq, sk, heads, q_shared=shared)
        code = launch()
        torch.cuda.synchronize()
        if code != 0:
            raise AssertionError(f"core {name}: btia_attn_core returned CUDA error {code}")
        q3 = q[None].expand(B, sq, HD) if shared else q.view(B, sq, HD)
        k3, v3 = kv[:, :HD].reshape(B, sk, HD), kv[:, HD:].reshape(B, sk, HD)
        cm = mask.float() if masked else torch.ones(B, sk, device=dev)
        plain = lambda: A.attend_log2(q3, k3, v3, cm, heads)
        ref = plain().float()
        got = out.view(B, sq, HD).float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"core {name}: output is not finite")
        err, tol = (got - ref).abs().max().item(), ref.abs().max().item() / 32
        if not err <= tol:
            raise AssertionError(f"core {name}: kernel disagrees with attend_log2: {err} > {tol}")
        if masked and bool(got[-1].any()):
            raise AssertionError(f"core {name}: the all-PAD row is not 0")
        split = lambda t, S: t.view(-1, S, heads, D).transpose(1, 2)
        qs = split(q, sq).expand(B, heads, sq, D) if shared else split(q, sq)
        keep = mask[:, None, None, :] if masked else None
        sdpa = lambda: F.scaled_dot_product_attention(qs, split(kv[:, :HD], sk), split(kv[:, HD:], sk),
                                                      attn_mask=keep)
        row = {
            "shape": [B, sq, sk, heads, D], "shared_query_table": shared, "masked": masked,
            "plan": A.short_plan([(B, heads, sq, sk)], D),
            "launches_per_serve_step": per_serve, "launches_per_train_step": per_train,
            "max_abs_err": err, "tol": tol,
            "ms": cuda_time_ms(launch, 20), "plain_ms": cuda_time_ms(plain, 3),
            "library_ms": cuda_time_ms(sdpa, 20), "library": "F.scaled_dot_product_attention",
        }
        row["bound_ms"], row["bound_by"] = bound_ms(4 * B * heads * sq * sk * D, nbytes(q, kv, mask, out))
        log(f"  core {name} ({B} x {sq} <- {sk}, {heads} heads of {D}{', one query table' if shared else ''}): "
            f"err {err:.4g} (tol {tol:.4g}) C entry {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"SDPA {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows[name] = row
        del q, kv, mask, out, ref, got, launch
    torch.cuda.empty_cache()
    per_step = {}
    for path, key in (("serve_step", "launches_per_serve_step"), ("train_step", "launches_per_train_step")):
        got = [r for r in rows.values() if r[key]]
        per_step[path] = {k: sum(r[k] * r[key] for r in got) for k in ("ms", "library_ms", "bound_ms")}
        per_step[path]["launches"] = sum(r[key] for r in got)
        log(f"  core per {path.replace('_', ' ')} ({per_step[path]['launches']} launches): C entry "
            f"{per_step[path]['ms']:.3f} ms, SDPA {per_step[path]['library_ms']:.3f} ms, "
            f"bound {per_step[path]['bound_ms']:.3f} ms")
    return rows, per_step


def check_int8_kernel(torch, dev):
    """Phase 2, int8: K8 against its plain twin at each FFN shape of the
    int8 serve step, in bf16 on the card. The integer product is exact on
    both sides and the epilogue is the same f32 arithmetic, so each element
    must agree to one bf16 step at its magnitude; a floor of 1e-6 of the
    largest magnitude covers the tanh-GELU's cancelling 1 + tanh(z) (z < -4,
    outputs below 3e-5), where the two f32 tanh differ in the last place.
    Times: the ops API's entry (its wrapper: both kernels and the weight's
    quantization and (N, K) copy), the model's road (``road_ms``:
    ``int8_matmul_nk`` on the weight prepared once, as an Mlp runs it: at
    a GELU site (fc1) the row quantization and the GEMM, which also takes
    the output's row amax; at the others (fc2) the GEMM alone on bf16 x at
    its rows' amax, quantizing x itself), each of the entry's two kernels
    alone (``quantize_ms``: the row quantization, which must give the
    twin's xi and sx bit for bit; ``gemm_ms``: the int8 GEMM on the
    quantized rows and the (N, K) weight), the twin, ``torch._int_mm`` on
    the pre-quantized operands (the int8 product only, the library
    yardstick) and a bf16 ``torch.matmul``. The model's road must give the
    entry's output bit for bit (so the GEMM's own quantization of bf16 x is
    the row quantization's, held through the exact integer products), the
    row amax the twin's; the row-parallel road's GEMM on bf16 x into int32
    accumulators must give the twin's exactly, and its epilogue on them
    the twin's within one bf16 step. Then the same at ``INT8_WIDE_K``,
    where the quantization takes its two-pass kernel."""
    from btia_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    launches_before = Q.int8_matmul_fused.launches
    for name, M, K, N, act, per_step in INT8_SITES + (INT8_WIDE_K,):
        x = (torch.randn(M, K, generator=g, device=dev) * 2).to(torch.bfloat16)
        w = torch.randn(K, N, generator=g, device=dev) * K**-0.5
        b = torch.randn(N, generator=g, device=dev) * 0.02
        w_i8, ws = Q.quantize_weight(w)
        kernel = lambda: Q.int8_matmul_fused(x, w_i8, ws, b, act=act)
        plain = lambda: Q._int8_mm_plain(x, w_i8, ws, b, act, torch.bfloat16)
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"K8 {name}: kernel output is not finite")
        xi, sx = Q._quantize_rows_cuda(x)
        xi_ref, sx_ref = Q._quantize_rows_plain(x)
        if not (torch.equal(xi, xi_ref) and torch.equal(sx, sx_ref)):
            raise AssertionError(f"K8 {name}: the row quantization differs from its twin")
        del xi_ref, sx_ref
        w_nk = w_i8.t().contiguous()
        x_amax = Q._row_amax_plain(x)
        if act is not None:  # fc1: the quantization, the GEMM and the output's row amax
            road = lambda: Q.int8_matmul_nk(x, w_nk, ws, b, act, row_amax=True)
            y_road, amax = road()
            if not torch.equal(amax, Q._row_amax_plain(y_road)):
                raise AssertionError(f"K8 {name}: the output's row amax differs from its twin")
            del amax
        else:  # fc2: the GEMM on bf16 x at its rows' amax
            road = lambda: Q.int8_matmul_nk(x, w_nk, ws, b, x_amax=x_amax)
            y_road = road()
        if not torch.equal(y_road, out):
            raise AssertionError(f"K8 {name}: the model's road differs from the ops API's entry")
        acc = Q._int8_gemm_cuda(x, x_amax, w_nk, ws, None, None, torch.int32, a_bf16=True)
        if not (torch.equal(acc, Q._int8_acc_plain(xi, w_nk))
                and torch.equal(Q._int8_gemm_cuda(xi, sx, w_nk, ws, None, None, torch.int32), acc)):
            raise AssertionError(f"K8 {name}: the GEMM's int32 accumulators differ from the twin's")
        deq_bad = bf16_steps_off(torch, Q._int8_dequant_cuda(acc, x_amax, ws, b, act, torch.bfloat16),
                                 Q._int8_dequant_plain(acc, x_amax, ws, b, act, torch.bfloat16))
        if deq_bad:
            raise AssertionError(f"K8 {name}: {deq_bad} dequantized elements beyond one bf16 step of the twin")
        del y_road, acc
        diff = (out.float() - ref.float()).abs()
        bad = bf16_steps_off(torch, out, ref)
        x_i8 = Q.quantize_activation(x)[0]
        w_col = w_i8.t().contiguous().t()  # (K, N), column-major
        try:
            torch._int_mm(x_i8, w_col)
            library = lambda: torch._int_mm(x_i8, w_col)
        except RuntimeError as e:
            log(f"  K8 {name}: torch._int_mm refused the shape: {e}")
            library = None
        w_bf = w.to(torch.bfloat16)
        row = {
            "shape": [M, K, N], "act": act, "launches_per_step": per_step,
            "max_abs_err": diff.max().item(), "elements_off": bad,
            "ms": cuda_time_ms(kernel, 10), "road_ms": cuda_time_ms(road, 10), "plain_ms": cuda_time_ms(plain, 3),
            "quantize_ms": cuda_time_ms(lambda: Q._quantize_rows_cuda(x), 10),
            "gemm_ms": cuda_time_ms(
                lambda: Q._int8_gemm_cuda(xi, sx, w_nk, ws, b, act, torch.bfloat16), 10),
            "library_ms": None if library is None else cuda_time_ms(library, 10),
            "library": "torch._int_mm (int8 product only)",
            "bf16_matmul_ms": cuda_time_ms(lambda: x @ w_bf, 10),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * M * K * N, nbytes(x, w_i8, ws, b) + M * N * 2, PEAK_INT8_OPS)
        # The halves' own bounds: the quantization reads x and writes xi and
        # sx; the GEMM reads xi, sx, the weight, ws and b and writes y.
        row["quantize_bound_ms"] = bound_ms(0, nbytes(x, xi, sx))[0]
        row["gemm_bound_ms"] = bound_ms(2 * M * K * N, nbytes(xi, sx, w_nk, ws, b) + M * N * 2, PEAK_INT8_OPS)[0]
        log(f"  K8 {name} ({M} x {K} -> {N}, {act}): err {row['max_abs_err']:.4g}, {bad} elements "
            f"beyond one bf16 step; entry {row['ms']:.4f} ms, model's road {row['road_ms']:.4f} ms (quantize "
            f"{row['quantize_ms']:.4f}, "
            f"GEMM {row['gemm_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
            f"_int_mm {row['library_ms']}, bf16 matmul {row['bf16_matmul_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; quantize "
            f"{row['quantize_bound_ms']:.4f}, GEMM {row['gemm_bound_ms']:.4f})")
        if bad:
            raise AssertionError(f"K8 {name}: {bad} elements disagree with the plain twin")
        rows[name] = row
        del x, w, out, ref, diff, x_i8, w_col, w_bf, xi, sx, w_nk, x_amax
    Q.int8_matmul_fused.launches = launches_before  # not main-path launches
    torch.cuda.empty_cache()
    return rows


def bf16_steps_off(torch, out, ref) -> int:
    """Elements of `out` beyond one bf16 step of `ref` at its magnitude, with
    a floor of 1e-6 of the largest magnitude (``check_int8_kernel``)."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return int((diff > step + 1e-6 * mag.max()).sum())


def _question_mask(torch, dev, g, n, s):
    """(n, s) question masks of 4..s real tokens; the last row all PAD, as
    Predictor's bucket padding makes."""
    lengths = torch.randint(4, s + 1, (n,), generator=g, device=dev)
    m = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    m[-1] = False
    return m


def check_layernorm(torch, name, x, scale, bias, eps=1e-6, iters=20):
    """K7 against its plain twin (``_ln_exact``): in bf16 each element within
    one bf16 step at its magnitude, in f32 within 1e-5 of the largest
    magnitude, and in bf16 too within that (an output near 0, where the
    bias cancels, whose f32 value differs by a rounding before the cast).
    Times the kernel (through its wrapper, and its C entry alone), the twin
    and ``F.layer_norm`` (timing only: its variance is the two-pass one),
    with the bound (bytes)."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.ops import norms as N

    out = N.layernorm_fast(x, scale, bias, eps)
    ref = N._ln_exact(x, scale, bias, eps)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"K7 {name}: kernel output is not finite")
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    floor = 1e-5 * mag.max().item()
    if x.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        bad = int((diff > step + floor).sum())
    else:
        bad = int((diff > floor).sum())
    D = x.shape[-1]
    ws, wb = scale.to(x.dtype), bias.to(x.dtype)
    row = {
        "shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
        "max_abs_err": diff.max().item(), "elements_off": bad,
        "ms": cuda_time_ms(lambda: N.layernorm_fast(x, scale, bias, eps), iters),
        "plain_ms": cuda_time_ms(lambda: N._ln_exact(x, scale, bias, eps), max(2, iters // 4)),
        "library_ms": cuda_time_ms(lambda: F.layer_norm(x, (D,), ws, wb, eps), iters),
    }
    y, sc, bi, lib, st = torch.empty_like(x), scale.float().contiguous(), bias.float().contiguous(), _native.lib(), \
        torch.cuda.current_stream().cuda_stream
    row["c_entry_ms"] = cuda_time_ms(lambda: lib.btia_layernorm(
        x.data_ptr(), y.data_ptr(), sc.data_ptr(), bi.data_ptr(), x.numel() // D, D, eps, int(x.dtype == torch.float32),
        st), iters)
    row["bound_ms"], row["bound_by"] = bound_ms(8 * x.numel(), 2 * nbytes(x) + nbytes(scale, bias))
    log(f"  K7 {name} {tuple(x.shape)} {row['dtype']}: err {row['max_abs_err']:.4g}, {bad} elements "
        f"beyond the limit; kernel {row['ms']:.4f} ms (C entry {row['c_entry_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
        f"F.layer_norm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if bad:
        raise AssertionError(f"K7 {name}: {bad} elements disagree with the plain twin")
    return row


def check_layernorm_bwd(torch, name, x, scale, bias, g, eps=1e-6, iters=20):
    """K7's backward kernel (``layernorm_backward``'s CUDA half) against its
    plain twin (``_ln_exact_vjp``, the vjp of ``_ln_exact``): dx within one
    bf16 step at each element's magnitude plus 1e-5 of its row's largest
    (f32: within 1e-5 of the row's largest; a row where the variance's clamp
    binds has dx of order 1 / sqrt(eps), which would hide the other rows);
    dscale and dbias within 1e-4 of their largest magnitude; a second call
    equal to the first bit for bit. Times the kernel (through its wrapper),
    the twin and ``torch.ops.aten.native_layer_norm_backward`` (timing only,
    on the row statistics of ``native_layer_norm``, its variance the
    two-pass one), with the bound: x and g read, dx written, scale read,
    dscale and dbias written, against ~20 f32 operations an element on the
    CUDA cores. The kernel also through its C entry alone."""
    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.ops import norms as N

    got = N._layernorm_bwd_cuda(x, scale, bias, g, eps)
    again = N._layernorm_bwd_cuda(x, scale, bias, g, eps)
    ref = N._ln_exact_vjp(x, scale, bias, g, eps)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t.float()).all()) for t in got):
        raise AssertionError(f"K7 backward {name}: kernel output is not finite")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    dx, rx = got[0].float(), ref[0].float()
    diff = (dx - rx).abs()
    floor = 1e-5 * rx.abs().amax(-1, keepdim=True)
    lim = floor + bf16_steps(torch, rx) if x.dtype == torch.bfloat16 else floor
    bad = int((diff > lim).sum())
    perr = [(a - b).abs().max().item() for a, b in zip(got[1:], ref[1:])]
    ptol = [1e-4 * b.abs().max().item() for b in ref[1:]]
    D = x.shape[-1]
    w, b = scale.to(x.dtype), bias.to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, (D,), w, b, eps)
    lib = lambda: torch.ops.aten.native_layer_norm_backward(g, x, (D,), mean, rstd, w, b, [True, True, True])
    row = {
        "shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
        "max_abs_err": diff.max().item(), "elements_off": bad, "dscale_dbias_err": perr, "dscale_dbias_tol": ptol,
        "two_calls_bitwise_equal": bitwise,
        "ms": cuda_time_ms(lambda: N._layernorm_bwd_cuda(x, scale, bias, g, eps), iters),
        "plain_ms": cuda_time_ms(lambda: N._ln_exact_vjp(x, scale, bias, g, eps), max(2, iters // 4)),
        "library_ms": cuda_time_ms(lib, iters),
    }
    M, elem = x.numel() // D, int(x.dtype == torch.float32)
    sc, lib, st = scale.float().contiguous(), _native.lib(), torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(x), torch.empty(D, device=x.device), torch.empty(D, device=x.device)]
    rows = lib.btia_layernorm_bwd_parts(x.data_ptr(), g.data_ptr(), sc.data_ptr(), outs[0].data_ptr(), M, D, elem)
    outs.append(torch.empty(rows, 2 * D, device=x.device))
    row["c_entry_ms"] = cuda_time_ms(lambda: lib.btia_layernorm_bwd(
        x.data_ptr(), g.data_ptr(), sc.data_ptr(), *(t.data_ptr() for t in outs), rows, M, D, eps, elem, st), iters)
    row["bound_ms"], row["bound_by"] = bound_ms(20 * x.numel(), 3 * nbytes(x) + 12 * D, PEAK_F32_SIMT)
    log(f"  K7 backward {name} {tuple(x.shape)} {row['dtype']}: dx err {row['max_abs_err']:.4g}, {bad} elements "
        f"beyond the limit; dscale / dbias err {perr[0]:.3g} / {perr[1]:.3g} (tol {ptol[0]:.3g} / {ptol[1]:.3g}); "
        f"two calls bitwise equal {bitwise}; kernel {row['ms']:.4f} ms (C entry {row['c_entry_ms']:.4f}), "
        f"plain {row['plain_ms']:.4f} ms, "
        f"native_layer_norm_backward {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if bad or not bitwise or any(e > t for e, t in zip(perr, ptol)):
        raise AssertionError(f"K7 backward {name}: {bad} dx elements off, dscale / dbias err {perr} (tol {ptol}), "
                             f"two calls bitwise equal: {bitwise}")
    return row


def ops_api_phase(torch, dev, counters):
    """Phase 2b: the ops API at full width. One main-path run through the
    entry points a caller uses (``mha``, ``mha_bshd``, ``bicross_attention``,
    ``bicross_bshd``, ``layernorm_fast``, and ``set_attention_impl``) with
    every counter set to 0 just before and read just after (OPS_COUNTS);
    then K5, K6 and K7 against their plain twins, timed beside the twin, a
    library yardstick and the bound, and each Function's backward against
    autograd through its twin."""
    import torch.nn.functional as F

    import btia_tpu_torch.ops as O
    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import bicross as BX
    from btia_tpu_torch.ops import norms as N

    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(bf)
    t = lambda x: x.transpose(1, 2)  # (B, S, H, D) <-> (B, H, S, D), a view
    ones = lambda b, n: torch.ones(b, n, dtype=torch.bool, device=dev)

    B5, H5, S5, _, D5 = K5_VITL
    q5, k5, v5 = (randn(B5, H5, S5, D5) for _ in range(3))
    Bh, Hh, Sqh, Skh, Dh = K5_HEAD
    qh, kh, vh = randn(Bh, Sqh, Hh, Dh), randn(Bh, Skh, Hh, Dh), randn(Bh, Skh, Hh, Dh)
    mh = torch.cat([ones(Bh, N_VIT_B), _question_mask(torch, dev, g, Bh, SEQ)], 1)
    Bp, Hp, Nip, Ntp, Dp = K6_POOLED
    pooled = [randn(Bp, Hp, n, Dp) for n in (Nip, Nip, Nip, Ntp, Ntp, Ntp)]
    mp = _question_mask(torch, dev, g, Bp, Ntp)
    Bl, Hl, Nil, Ntl, Dl = K6_LONG
    long_bshd = [randn(Bl, n, Hl, Dl) for n in (Nil, Nil, Nil, Ntl, Ntl, Ntl)]
    ml = _question_mask(torch, dev, g, Bl, Ntl)
    ln_in = {}
    for name, M, D in K7_SHAPES:
        x = (torch.randn(M, D, generator=g, device=dev) * 2 + 0.5).to(bf)
        ln_in[name] = (x, 1 + 0.2 * torch.randn(D, generator=g, device=dev),
                       0.1 * torch.randn(D, generator=g, device=dev))
    x, sc, bi = ln_in["vit_l"]
    ln_in["vit_l_f32"] = (x.float(), sc, bi)

    # The main-path run.
    torch.cuda.synchronize()
    _zero(counters)
    outs = {"k5_vitl": O.mha(q5, k5, v5, impl="pallas")}
    O.set_attention_impl("pallas")
    try:
        outs["k5_switch"] = O.mha(q5, k5, v5)
    finally:
        O.set_attention_impl("auto")
    outs["k5_head"] = O.mha_bshd(qh, kh, vh, mh)
    outs["k6_pooled"] = O.bicross_attention(*pooled, mp, impl="pallas")
    outs["k6_long"] = O.bicross_bshd(*long_bshd, ml)
    for name, (x, sc, bi) in ln_in.items():
        outs[f"k7_{name}"] = N.layernorm_fast(x, sc, bi, 1e-6)
    torch.cuda.synchronize()
    counts = [f.launches for f in counters]
    log("phase 2b: the ops API's main-path run launched "
        + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts)))
    if counts != OPS_COUNTS or N.layernorm.launches != 0:
        raise AssertionError(f"ops API launch counts {counts} != {OPS_COUNTS}, or the models' layernorm "
                             f"launched K7 {N.layernorm.launches} times")
    shapes = {"k5_vitl": q5.shape, "k5_switch": q5.shape, "k5_head": qh.shape,
              "k6_pooled": (pooled[0].shape, pooled[3].shape),
              "k6_long": (long_bshd[0].shape, long_bshd[3].shape),
              **{f"k7_{n}": x.shape for n, (x, _, _) in ln_in.items()}}
    for name, out in outs.items():
        got = tuple(o.shape for o in out) if isinstance(out, tuple) else out.shape
        if got != shapes[name] or not bool(torch.isfinite(_flat_f32(out)).all()):
            raise AssertionError(f"ops API {name}: shape {got} (expected {shapes[name]}) or not finite")
    if not torch.equal(outs["k5_switch"], outs["k5_vitl"]):
        raise AssertionError("mha() under set_attention_impl('pallas') differs from mha(impl='pallas')")
    del outs

    # Each kernel against its twin, timed.
    rows = {}
    sdpa = F.scaled_dot_product_attention
    key_mask = lambda m: m[:, None, None, :]
    rows["k5_vitl"] = run_case(
        "K5 ViT-L mha(impl='pallas') (16 x 16 heads x 577, D 64)",
        lambda: A.mha_bhsd_attention(q5, k5, v5),
        lambda: A._mha_bhsd_plain(q5, k5, v5, None),
        lambda: sdpa(q5, k5, v5),
        4 * B5 * H5 * S5 * S5 * D5, nbytes(q5, k5, v5) + nbytes(q5), iters=20,
    )
    rows["k5_head"] = run_case(
        "K5 AD head, mha_bshd long road (64 x 2048 <- 229, 8 heads, D 96)",
        lambda: A.mha_bhsd_attention(t(qh), t(kh), t(vh), mh),
        lambda: A._mha_bhsd_plain(t(qh), t(kh), t(vh), mh),
        lambda: sdpa(t(qh), t(kh), t(vh), attn_mask=key_mask(mh)),
        4 * Bh * Hh * Sqh * Skh * Dh, nbytes(qh, kh, vh, mh) + nbytes(qh), iters=10,
    )
    qi, ki, vi, qt, kt, vt = pooled
    rows["k6_pooled"] = run_case(
        "K6 bicross_attention(impl='pallas'), pooled BTIA (2048 x 12 heads, 50 <-> 32)",
        lambda: BX.bicross_bhsd_attention(*pooled, mp),
        lambda: BX._bicross_plain(*pooled, mp),
        lambda: (sdpa(qi, kt, vt, attn_mask=key_mask(mp)), sdpa(qt, ki, vi)),
        2 * 4 * Bp * Hp * Nip * Ntp * Dp, nbytes(*pooled, mp) + nbytes(qi, qt), iters=10,
    )
    # A question of only PAD tokens (mp's last row): its image rows average
    # V over the Nt real text keys, as mha_reference and K5 do.
    out_i = BX.bicross_bhsd_attention(*pooled, mp)[0][-1].float()
    mean_v = vt[-1].float().mean(1, keepdim=True).expand_as(out_i)
    err, tol = (out_i - mean_v).abs().max().item(), mean_v.abs().max().item() / 32
    rows["k6_pooled"]["masked_row_vs_mean_v"] = [err, tol]
    log(f"  K6 fully masked row vs mean V: err {err:.4g} (tol {tol:.4g})")
    if not err <= tol:
        raise AssertionError(f"K6: a fully masked row is not the mean of V: {err} > {tol}")
    del out_i, mean_v
    lv = [t(x) for x in long_bshd]
    rows["k6_long"] = run_case(
        "K6 bicross_bshd long tile (16 x 12 heads, 577 <-> 64)",
        lambda: BX.bicross_bhsd_attention(*lv, ml),
        lambda: BX._bicross_plain(*lv, ml),
        lambda: (sdpa(lv[0], lv[4], lv[5], attn_mask=key_mask(ml)), sdpa(lv[3], lv[1], lv[2])),
        2 * 4 * Bl * Hl * Nil * Ntl * Dl, nbytes(*long_bshd, ml) + nbytes(lv[0], lv[3]), iters=20,
    )
    for name, (x, sc, bi) in ln_in.items():
        rows[f"k7_{name}"] = check_layernorm(torch, name, x, sc, bi)
    # K7's block-per-row kernel (1024 < D <= 4096) and its two-read kernel
    # (D > 4096, any width), at widths no main path has: the largest the
    # first takes, a ragged one, and 6144 and 8192; at 8192 also in place
    # (as K1's post-LN writes), against the twin within one bf16 step.
    for M, D in ((4096, 4096), (3000, 1500), (2048, 6144), (2048, 8192)):
        x = (torch.randn(M, D, generator=g, device=dev) * 2 + 0.5).to(bf)
        sc, bi = 1 + 0.2 * torch.randn(D, generator=g, device=dev), 0.1 * torch.randn(D, generator=g, device=dev)
        rows[f"k7_wide_{D}"] = check_layernorm(torch, f"wide {D}", x, sc, bi, iters=5)
        if D == 1500:
            ln_in["ragged_1500"] = (x, sc, bi)
    # In place (as K1's post-LN writes) at 8192, at the text rows' 768 (the
    # 16-byte road) and at the ragged 1500.
    for key, (x, sc, bi) in (("k7_wide_8192", (x, sc, bi)), ("k7_text", ln_in["text"]),
                             ("k7_wide_1500", ln_in["ragged_1500"])):
        y = x.clone()
        N._layernorm_cuda(y, sc, bi, 1e-6, out=y)
        ref = N._ln_exact(x, sc, bi, 1e-6).float()
        off = int(((y.float() - ref).abs() > bf16_steps(torch, ref) + 1e-5 * ref.abs().max()).sum())
        rows[key]["in_place_elements_off"] = off
        log(f"  K7 {key} {tuple(x.shape)} in place: {off} elements beyond one bf16 step of the twin")
        if off:
            raise AssertionError(f"K7 in place at {tuple(x.shape)}: {off} elements disagree with the twin")
        del y, ref
    # K7's backward kernel against its twin, in bf16 and f32, at K7_BWD_SHAPES
    # and on BERT's shape with constant rows (0.5 and -2.0, whose sums are
    # exact in any order: mean2 - mean^2 = 0, the clamp at its bound).
    for name, M, D in K7_BWD_SHAPES + (("clamped", B_TRAIN * SEQ, 768),):
        for dt in (bf, torch.float32):
            x = (torch.randn(M, D, generator=g, device=dev) * 2 + 0.5).to(dt)
            if name == "clamped":
                x[:4], x[4:8] = 0.5, -2.0
            sc, bi = 1 + 0.2 * torch.randn(D, generator=g, device=dev), 0.1 * torch.randn(D, generator=g, device=dev)
            gr = torch.randn(M, D, generator=g, device=dev).to(dt)
            key = f"k7_bwd_{name}" + ("" if dt == bf else "_f32")
            rows[key] = check_layernorm_bwd(torch, f"{name}", x, sc, bi, gr, iters=5 if name == "wide" else 20)
            del x, gr
    # ... and on f32 rows whose rounded variance is negative: the clamp cuts.
    for D in K7_CLAMP_WIDTHS:
        rows[f"k7_clamp_bwd_{D}"] = check_layernorm_bwd_clamp(torch, g, D)
    # K6 at widths of every template (D 16..256; the main paths run 64; D 136
    # to 256 through bicross_attention(impl="pallas"), which took only D <= 128
    # before the short-sequence kernel) at a small masked shape on strided
    # views, within max|twin| / 32; K5 at K5_WIDTHS, masked
    # and dense, on the long road's (B, S, H, D) views, at a batch of 1 and
    # with K and V broadcast over the batch (a zero stride, copied).
    widths = {}

    def hold(name, out, ref):
        out, ref = _flat_f32(out), _flat_f32(ref)
        err, tol = (out - ref).abs().max().item(), ref.abs().max().item() / 32
        widths[name] = [err, tol]
        if not (bool(torch.isfinite(out).all()) and err <= tol):
            raise AssertionError(f"{name}: err {err} > {tol} or not finite")

    for D in K6_WIDTHS:
        q, k, v = randn(2, 4, 200, D), randn(2, 4, 300, D), randn(2, 4, 300, D)
        m = torch.cat([ones(2, 1), _question_mask(torch, dev, g, 2, 299)], 1)
        # K6 on strided views: 200 image tokens, 40 text tokens.
        both = (q, k[:, :, :200], v[:, :, :200], *(x[:, :, :40] for x in (k, q, v)))
        out = (O.bicross_attention(*both, m[:, :40], impl="pallas") if D > 128
               else BX.bicross_bhsd_attention(*both, m[:, :40]))
        hold(f"K6_D{D}", out, BX._bicross_plain(*both, m[:, :40]))
    for D in K5_WIDTHS:
        q, k, v = randn(2, 4, 200, D), randn(2, 4, 300, D), randn(2, 4, 300, D)
        m = torch.cat([ones(2, 1), _question_mask(torch, dev, g, 2, 299)], 1)
        for mask, how in ((m, "masked"), (None, "dense")):
            hold(f"K5_D{D}_{how}", A.mha_bhsd_attention(q, k, v, mask), A._mha_bhsd_plain(q, k, v, mask))
        qs, ks, vs = randn(2, 150, 3, D), randn(2, 260, 3, D), randn(2, 260, 3, D)
        ms = _question_mask(torch, dev, g, 2, 260)
        ms[-1, 0] = True
        hold(f"K5_D{D}_views", A.mha_bhsd_attention(t(qs), t(ks), t(vs), ms),
             A._mha_bhsd_plain(t(qs), t(ks), t(vs), ms))
        q1, k1, v1 = randn(1, 3, 130, D), randn(1, 3, 70, D), randn(1, 3, 70, D)
        hold(f"K5_D{D}_batch1", A.mha_bhsd_attention(q1, k1, v1), A._mha_bhsd_plain(q1, k1, v1, None))
        qb, kb, vb = randn(2, 3, 130, D), k1.expand(2, 3, 70, D), v1.expand(2, 3, 70, D)
        hold(f"K5_D{D}_broadcast", A.mha_bhsd_attention(qb, kb, vb), A._mha_bhsd_plain(qb, kb, vb, None))
    log("  K5 / K6 at every head width, max abs err / tol: "
        + ", ".join(f"{n} {e:.3g}/{t:.3g}" for n, (e, t) in widths.items()))
    rows["head_widths"] = widths

    gb = torch.Generator(device=dev).manual_seed(4)
    rows["K5_backward"] = check_backward(
        torch, "K5", lambda a, b, c: O.mha(a, b, c, impl="pallas"),
        lambda a, b, c: A._mha_bhsd_plain(a, b, c, None), [q5, k5, v5], gb)
    rows["K6_backward"] = check_backward(
        torch, "K6", lambda *xs: O.bicross_attention(*xs, mp, impl="pallas"),
        lambda *xs: BX._bicross_plain(*xs, mp), pooled, gb)
    # K7's Function: its backward kernel through autograd against autograd
    # through the twin, at ViT-L's f32 rows (bf16 is held above, element by
    # element): each gradient within 1e-5 of its largest magnitude.
    x, sc, bi = ln_in["vit_l_f32"]
    rows["K7_backward"] = check_backward(
        torch, "K7", lambda a, b, c: N.layernorm_fast(a, b, c, 1e-6),
        lambda a, b, c: N._ln_exact(a, b, c, 1e-6), [x, sc, bi], gb, tol_div=1e5)
    torch.cuda.empty_cache()
    return rows, counts


def check_layernorm_bwd_clamp(torch, g, D, M=512, eps=1e-6):
    """K7's backward kernel where the variance's clamp cuts (keep false), on
    f32 rows of width D: 1000 + N(0, 0.1^2), whose variance (0.01) is below
    the rounding of mean2 and mean^2 (both on a grid of 1/16 near 1e6), so
    that mean2 - mean^2 rounds below 0, to 0 or above 0 by the order of the
    sums, the kernel's and the twin's apart. The kernel's own x̂ = (x - mean)
    * inv comes from its forward at scale 1 and bias 0 (the backward
    recomputes the same statistics). A row whose inv is 1 / sqrt(eps) (|x̂|
    up to ~400, not ~2: the rounded variance <= 0) must have dx equal to
    one of two closed forms in f64 on that x̂, which differ by orders of
    magnitude: inv * (gs - mean(gs)), the clamped rule (variance < 0), or
    inv * (gs - mean(gs) - x̂ mean(gs x̂)) (variance 0, the clamp at its
    bound passing the gradient), within 1e-5 of the row's largest (the
    second, whose f32 sum of gs x̂ over ~400-sized terms dominates it, within
    1e-4).
    Fails unless every such row is one of them, at least 16 rows take the
    clamped rule, those of them where the twin's own rounded variance is
    negative too (at least 4) agree with the twin (``_ln_exact_vjp``)
    within 1e-5 of the row's largest, dscale and dbias agree with sum(g x̂)
    and sum(g) in f64 within 1e-4 of their largest, and a second call
    equals the first bit for bit."""
    from btia_tpu_torch.ops import norms as N

    dev = torch.device("cuda", 0)
    x = 1000 + 0.1 * torch.randn(M, D, generator=g, device=dev)
    sc, bi = 1 + 0.2 * torch.randn(D, generator=g, device=dev), 0.1 * torch.randn(D, generator=g, device=dev)
    gr = torch.randn(M, D, generator=g, device=dev)
    xh = N._layernorm_cuda(x, torch.ones_like(sc), torch.zeros_like(bi), eps).double()
    got = N._layernorm_bwd_cuda(x, sc, bi, gr, eps)
    again = N._layernorm_bwd_cuda(x, sc, bi, gr, eps)
    ref = N._ln_exact_vjp(x, sc, bi, gr, eps)
    mean = x.mean(-1, keepdim=True)  # the twin's statistics, rounded as _ln_exact rounds them
    twin_neg = ((x * x).mean(-1, keepdim=True) - mean * mean < 0)[:, 0]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    cut = xh.abs().amax(-1) > 50  # inv = 1 / sqrt(eps)
    gs, dx = gr.double() * sc.double(), got[0].double()
    gs_c = gs - gs.mean(-1, keepdim=True)
    clamped, full = eps ** -0.5 * gs_c, eps ** -0.5 * (gs_c - xh * (gs * xh).mean(-1, keepdim=True))
    off = lambda a, b: (a - b).abs().amax(-1) / b.abs().amax(-1)
    keep_false, keep_true = cut & (off(dx, clamped) <= 1e-5), cut & (off(dx, full) <= 1e-4)
    stray = int((cut & ~keep_false & ~keep_true).sum())
    both = keep_false & twin_neg
    twin_err = off(dx[both], ref[0][both].double()).max().item() if bool(both.any()) else float("inf")
    perr = [(a.double() - b).abs().max().item() for a, b in zip(got[1:], ((gr.double() * xh).sum(0), gr.double().sum(0)))]
    ptol = [1e-4 * b.abs().max().item() for b in ((gr.double() * xh).sum(0), gr.double().sum(0))]
    row = {"shape": [M, D], "dtype": "float32", "rows_variance_le_0": int(cut.sum()),
           "rows_keep_false": int(keep_false.sum()), "rows_keep_true": int(keep_true.sum()), "rows_stray": stray,
           "rows_against_twin": int(both.sum()), "twin_rel_err": twin_err, "dscale_dbias_err": perr,
           "dscale_dbias_tol": ptol, "two_calls_bitwise_equal": bitwise}
    log(f"  K7 backward clamp {M} x {D} f32: {row['rows_variance_le_0']} rows with the rounded variance <= 0, "
        f"{row['rows_keep_false']} on the clamped rule, {row['rows_keep_true']} at the bound, {stray} neither; "
        f"{row['rows_against_twin']} held against the twin (rel err {twin_err:.3g}); dscale / dbias err "
        f"{perr[0]:.3g} / {perr[1]:.3g} (tol {ptol[0]:.3g} / {ptol[1]:.3g}); two calls bitwise equal {bitwise}")
    if (stray or row["rows_keep_false"] < 16 or row["rows_against_twin"] < 4 or not twin_err <= 1e-5 or not bitwise
            or any(e > t for e, t in zip(perr, ptol))):
        raise AssertionError(f"K7 backward where the clamp cuts, D {D}: {row}")
    return row


def layernorm_road(torch, step):
    """One serve step, ``step(0)``, with its standalone LayerNorms counted by
    (rows, width) at their callers (``layernorm`` in the model's modules),
    ``layernorm``'s and ``layernorm_fast``'s K7 launches read around it, and
    the plain formula's calls on CUDA tensors counted (``_ln_exact``, in
    ``ops/norms.py`` and as ``fused_attn`` holds it for K1/K2's twins).
    Returns (census, dtypes, model launches, ops-API launches, plain calls
    on the card)."""
    from btia_tpu_torch.models import bert, layers
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.ops import norms as N

    census, dtypes = {}, set()
    real = N.layernorm

    def spy(x, *a, **kw):
        key = (x.numel() // x.shape[-1], x.shape[-1])
        census[key] = census.get(key, 0) + 1
        dtypes.add(str(x.dtype).removeprefix("torch."))
        return real(x, *a, **kw)

    mods = (layers, bert, FA)
    for m in mods:
        m.layernorm = spy
    before = N.layernorm.launches, N.layernorm_fast.launches
    try:
        with plain_formula_calls() as plain:
            step(0)
            torch.cuda.synchronize()
    finally:
        for m in mods:
            m.layernorm = real
    return (census, dtypes, N.layernorm.launches - before[0], N.layernorm_fast.launches - before[1], plain[0])


@contextlib.contextmanager
def plain_formula_calls():
    """Counts the plain formula's calls on CUDA tensors in the body
    (``_ln_exact`` in ``ops/norms.py``, where K7's backward twin calls it
    too, and as ``fused_attn`` holds it for K1/K2's twins): yields a
    one-element list."""
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.ops import norms as N

    calls, real = [0], N._ln_exact

    def exact(x, *a):
        calls[0] += int(x.is_cuda)
        return real(x, *a)

    N._ln_exact = FA._ln_exact = exact
    try:
        yield calls
    finally:
        N._ln_exact = FA._ln_exact = real


def check_layernorm_road(torch, step, what):
    """``layernorm_road`` held: the census SERVE_LN_CENSUS, each LayerNorm one
    K7 launch through ``layernorm`` (none through ``layernorm_fast``), and the
    plain formula never on a CUDA tensor."""
    census, dtypes, launches, fast, plain = layernorm_road(torch, step)
    n = sum(census.values())
    log(f"phase 4: one {what} runs {n} standalone LayerNorms ({sorted(dtypes)}): "
        + ", ".join(f"{c} x ({m}, {d})" for (m, d), c in sorted(census.items()))
        + f"; K7 launches through layernorm {launches}, layernorm_fast {fast}; the plain formula on a CUDA "
          f"tensor {plain} times")
    if census != SERVE_LN_CENSUS or (launches, fast, plain) != (n, 0, 0):
        raise AssertionError(f"{what}: LayerNorm census {census} (want {SERVE_LN_CENSUS}), K7 launches "
                             f"{launches} / {fast}, plain formula on the card {plain}: each LayerNorm must "
                             f"launch K7 once")
    return census, dtypes


def layernorm_census(torch, dev, step, counters):
    """The standalone LayerNorms that one bf16 serve step runs, by (rows,
    width), each on K7 (``check_layernorm_road``); then K7, the plain formula
    and ``F.layer_norm`` timed at each shape, summed over the step's count
    (what the route to K7 saves against the plain formula)."""
    census, dtypes = check_layernorm_road(torch, step, "bf16 serve step")
    n = sum(census.values())
    g = torch.Generator(device=dev).manual_seed(5)
    launches = [f.launches for f in counters]
    per_shape = {}
    for (m, d), c in sorted(census.items()):
        x = (torch.randn(m, d, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        sc, bi = 1 + 0.2 * torch.randn(d, generator=g, device=dev), 0.1 * torch.randn(d, generator=g, device=dev)
        row = check_layernorm(torch, f"serve {m} x {d}", x, sc, bi)
        per_shape[f"{m}x{d}"] = {"count": c, **{k: row[k] for k in ("ms", "c_entry_ms", "plain_ms", "library_ms",
                                                                     "bound_ms")}}
    for f, before in zip(counters, launches):
        f.launches = before  # comparison launches are not main-path launches
    total = lambda key: sum(r["count"] * r[key] for r in per_shape.values())
    res = {"standalone_layernorms": n, "dtype": sorted(dtypes), "shapes": per_shape,
           "k7_ms_per_step": total("ms"), "k7_c_entry_ms_per_step": total("c_entry_ms"),
           "plain_ms_per_step": total("plain_ms"),
           "library_ms_per_step": total("library_ms"), "bound_ms_per_step": total("bound_ms")}
    log(json.dumps({"serve_step_layernorms": res}))
    return res


def switch_step(torch, step, counters, expected, what):
    """One serve step under a routing switch (already set by the caller),
    with every counter set to 0 just before and read just after."""
    torch.cuda.synchronize()
    _zero(counters)
    vals, _ = step(0)
    torch.cuda.synchronize()
    counts = [f.launches for f in counters]
    log(f"phase 4: one serve step under {what} launched "
        + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts)))
    if counts != expected:
        raise AssertionError(f"{what}: serve-step launch counts {counts} != {expected}")
    if vals.shape != (B_IMG, N_Q, 5):
        raise AssertionError(f"{what}: bad top-k")
    step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        step(i)
    torch.cuda.synchronize()
    return counts, 1e3 * (time.perf_counter() - t0) / TIMED_STEPS


def routing_switches_phase(torch, dev, smi, model, host_imgs, host_qids, serve_step, counters):
    """Phase 4, switches: the bf16 serve step under set_attention_impl("xla")
    (no attention kernel: XLA_COUNTS), under disable_fused() (K1, K2 0; K3 24
    and K4 21 from the unfused sites' routing) and with the models'
    LayerNorms on the plain formula (``plain_layernorms``, the road before
    this step's 74 reached K7), each timed, and each step's logits against
    the default step's within a tenth of the largest logit."""
    import btia_tpu_torch.ops as O

    @torch.inference_mode()
    def logits():
        imgs = torch.from_numpy(host_imgs[0]).to(dev)
        qids = torch.from_numpy(host_qids[0]).to(dev)
        return model.answer_questions(model.encode_image(imgs), qids).float()

    base = logits()
    scale = base.abs().max().item()
    res = {}
    for what, expected, road in (("set_attention_impl('xla')", XLA_COUNTS, lambda: attention_impl("xla")),
                                 ("disable_fused()", NO_FUSED_COUNTS, O.disable_fused),
                                 ("plain LayerNorms", PLAIN_LN_SERVE_COUNTS, plain_layernorms)):
        with road():
            counts, ms = switch_step(torch, serve_step, counters, expected, what)
            err = (logits() - base).abs().max().item()
        res[what] = {"ms_per_step": ms, "pairs_per_s": B_IMG * N_Q / (ms / 1e3),
                     "launches": dict(zip(KERNELS, counts)), "logits_max_abs_err_vs_default": err,
                     "max_logit": scale}
        # As phase 3: the plain road and the kernels round bf16 at other
        # places in every one of the 40 layers.
        if not err <= 0.1 * scale:
            raise AssertionError(f"{what}: logits differ from the default step's by {err} > {0.1 * scale}")
    log(json.dumps({"serve_step_switches": {**res, "card": smi}}))
    return res


_PORTED = ("gemm_bias_ws_kernel", "ln_rows_kernel", "ln_wide_kernel", "ln_bwd_rows_kernel", "ln_bwd_wide_kernel",
           "ln_bwd_cols_kernel", "flash_ws_kernel",
           "flash_attn_kernel", "short_flash_kernel", "quant_rows_kernel", "quant_rows_loop_kernel", "int8_gemm_kernel",
           "attn_simt_kernel", "gemm_f32_kernel")


def profile_step(torch, step, smi, what="serve_step"):
    """``--profile``: one step under ``torch.profiler``; prints the device
    time by kernel, grouped into the port's kernels, library matrix products
    and the rest, and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Device kernels only: a user annotation such as torch.optim's
    # "Optimizer.step#AdamW.step" also carries device time, that of the
    # kernels under it, which would count them twice.
    kernels = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")
    ]
    if not kernels:
        raise AssertionError("profiler recorded no device time")
    groups = {"ported": 0.0, "library_gemm": 0.0, "other": 0.0}
    for name, _, ms in kernels:
        if any(p in name for p in _PORTED):
            groups["ported"] += ms
        elif any(p in name.lower() for p in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["library_gemm"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    # The rest by kind of PyTorch kernel (the plain elementwise and reduction
    # passes, copies, cuDNN), by substrings of their names.
    kinds = {"elementwise": ("elementwise",), "reduce": ("reduce_kernel",), "copy": ("copy", "memcpy", "memset", "cat"),
             "cudnn": ("cudnn", "conv", "bn_")}
    rest = {k: 0.0 for k in (*kinds, "else")}
    for name, _, ms in kernels:
        low = name.lower()
        if any(p in name for p in _PORTED) or any(p in low for p in ("gemm", "xmma", "cutlass", "nvjet")):
            continue
        rest[next((k for k, subs in kinds.items() if any(x in low for x in subs)), "else")] += ms
    top = sorted(kernels, key=lambda r: -r[2])[:20]
    # A template kernel's name reads "void int8_gemm_kernel<...>(...)", one
    # in an anonymous namespace "void (anonymous namespace)::...".
    own = lambda p, n: n.removeprefix("void ").removeprefix("(anonymous namespace)::").startswith((p + "(", p + "<"))
    ported = {p: [sum(c for n, c, _ in kernels if own(p, n)),
                  sum(ms for n, _, ms in kernels if own(p, n))] for p in _PORTED}
    log(json.dumps({"profile": {
        "step": what, "step_wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms), "by_group_ms": groups, "other_by_kind_ms": rest,
        "ported_launches_ms": ported,
        "top_kernels": [{"name": n.removeprefix("void ").removeprefix("at::native::")[:200], "count": c, "ms": ms}
                        for n, c, ms in top],
        "card": smi,
    }}))


class _K7Launches:
    """K7's count: the launches of its two entries, ``layernorm`` (the
    models' LayerNorms) and ``layernorm_fast`` (the ops API), which keep a
    count each. Setting it (0 before a run; a count read before comparison
    launches, after them) sets ``layernorm_fast``'s and clears
    ``layernorm``'s, so that it reads back what was set."""

    __name__ = "layernorm"

    @property
    def launches(self) -> int:
        from btia_tpu_torch.ops import norms as N

        return N.layernorm.launches + N.layernorm_fast.launches

    @launches.setter
    def launches(self, n: int) -> None:
        from btia_tpu_torch.ops import norms as N

        N.layernorm.launches, N.layernorm_fast.launches = 0, n


def launch_counters():
    """The kernel entries' launch counters, K1..K8 and K7's backward
    (KERNELS)."""
    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import bicross as BX
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.ops import norms as N
    from btia_tpu_torch.ops.quant import int8_matmul_fused

    return (FA.fused_dense_attention, FA.fused_static_q_attention, A.bshd_flash_attention,
            A.fanout_attention, A.mha_bhsd_attention, BX.bicross_bhsd_attention, _K7Launches(),
            int8_matmul_fused, N.layernorm_backward)


@contextlib.contextmanager
def plain_layernorms():
    """The models' LayerNorms on the plain formula (``_ln_exact``, the road
    before they reached K7): each caller's ``layernorm`` replaced for the
    body. Only for a before / after comparison within one run."""
    from btia_tpu_torch.models import bert, layers
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.ops import norms as N

    mods = (layers, bert, FA)
    real = [m.layernorm for m in mods]
    for m in mods:
        m.layernorm = lambda x, scale, bias, eps=1e-6, fast=False: N._ln_exact(x, scale, bias, eps)
    try:
        yield
    finally:
        for m, r in zip(mods, real):
            m.layernorm = r


@contextlib.contextmanager
def attention_impl(impl):
    import btia_tpu_torch.ops as O

    O.set_attention_impl(impl)
    try:
        yield
    finally:
        O.set_attention_impl("auto")


def timed_ms(torch, fn, n):
    """ms a call of fn() over n calls after one warm call, host clock, ending
    in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def k7_vs_plain_ms(torch, fn, n, rounds=1):
    """ms a call of fn() with the LayerNorms on K7 and on the plain formula
    (``plain_layernorms``), timed in turns, K7, plain, plain, K7 (a second
    round: plain, K7, K7, plain), each turn ``timed_ms`` of n calls: a
    host-bound step drifts within a run by more than its two roads differ."""
    turns = {"k7": [], "plain": []}
    for road in ("k7", "plain", "plain", "k7", "plain", "k7", "k7", "plain")[:4 * rounds]:
        with plain_layernorms() if road == "plain" else contextlib.nullcontext():
            turns[road].append(timed_ms(torch, fn, n))
    return {road: sum(t) / len(t) for road, t in turns.items()} | {"turns": turns}


def _zero(counters) -> None:
    for f in counters:
        f.launches = 0


def train_phase(torch, dev, smi, counters):
    """Phase 5: full-width vqa_med_full through the port's Trainer."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.synthetic import generate_synthetic_vqa_med
    from btia_tpu_torch.train.trainer import Trainer, batch_to_device

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp) / "vqa_med"
        generate_synthetic_vqa_med(root, num_images=64)  # 128 pairs per split
        # The one cut: 2 warmup steps instead of 200, so that the learning
        # rate is up within the run. Model, batch and eval batch as registered.
        cfg = get_config("vqa_med_full", **{
            "data.data_dir": str(root), "train.warmup_steps": 2, "train.log_every": 1,
            "train.keep_checkpoints": 1,
        })
        t0 = time.perf_counter()
        trainer = Trainer(cfg, Path(tmp) / "run", device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f"phase 5: built vqa_med_full ({n_params / 1e6:.1f} M params) and its Trainer in "
            f"{time.perf_counter() - t0:.1f} s; batch {cfg.train.batch_size}, eval batch "
            f"{cfg.train.eval_batch_size}, warmup cut to 2 steps")
        t0 = time.perf_counter()
        history = trainer.fit(epochs=1)
        row = history[0] if history else {}
        log(f"  Trainer.fit(epochs=1): {trainer.state.step} steps, val evaluation and checkpoint in "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(row)}")
        if len(history) != 1 or not np.isfinite(row["train_loss"]) or "val_accuracy" not in row:
            raise AssertionError(f"fit: bad history {history}")
        state = trainer.state
        saved_step = state.step
        snapshot = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}

        # Ten steps on one repeated batch; the loss must fall.
        batch = batch_to_device(next(iter(trainer.data.iterator("train", seed=0))), dev)
        losses, counts = [], None
        for i in range(REPEATS):
            if i == 1:
                torch.cuda.synchronize()
                _zero(counters)
            with plain_formula_calls() if i == 1 else contextlib.nullcontext([0]) as plain:
                _, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
            if i == 1:
                torch.cuda.synchronize()
                counts, plain_calls = [f.launches for f in counters], plain[0]
        log(f"  {REPEATS} steps on one batch of {B_TRAIN}: loss {[round(x, 4) for x in losses]}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"the loss is not finite or does not fall: {losses}")
        log("  one train step launched " + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts))
            + f"; the plain LayerNorm formula on a CUDA tensor {plain_calls} times")
        if counts != TRAIN_COUNTS or plain_calls:
            raise AssertionError(f"train-step launch counts {counts} != {TRAIN_COUNTS}, or the plain LayerNorm "
                                 f"formula ran {plain_calls} times on the card")
        out["train_counts"] = counts

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TIMED_TRAIN_STEPS):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / TIMED_TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        if "--profile" in sys.argv[1:]:
            profile_step(torch, lambda: trainer.train_step(state, batch), smi, "train_step")
        # The same steps on K7's LayerNorms and on the plain formula (the
        # road before K7), in turns, and an eval forward's logits on both.
        ab = k7_vs_plain_ms(torch, lambda: trainer.train_step(state, batch), TIMED_TRAIN_STEPS)
        with torch.inference_mode():
            logits = trainer.model(batch["images"], batch["question_ids"], train=False)
            with plain_layernorms():
                ln_err = (trainer.model(batch["images"], batch["question_ids"], train=False) - logits).abs().max()
        plain_ln = {"ms_per_step": ab["plain"], "k7_ms_per_step": ab["k7"], "turns": ab["turns"],
                    "eval_logits_max_abs_err_vs_k7": ln_err.item(), "max_logit": logits.abs().max().item()}
        log(f"  train step in turns: {ab['k7']:.2f} ms on K7's LayerNorms, {ab['plain']:.2f} ms on the plain "
            f"formula (before K7: {BEFORE_K7_MS['train']}); eval logits K7 vs plain {json.dumps(plain_ln)}")
        if not plain_ln["eval_logits_max_abs_err_vs_k7"] <= 0.1 * plain_ln["max_logit"]:
            raise AssertionError(f"vqa_med_full: logits on K7 and on the plain LayerNorms disagree: {plain_ln}")

        # The test split at the eval batch of 128.
        torch.cuda.synchronize()
        _zero(counters)
        metrics = trainer.evaluate("test")
        torch.cuda.synchronize()
        eval_counts = [f.launches for f in counters]
        log(f"  evaluate('test') at batch {cfg.train.eval_batch_size}: {json.dumps(metrics)}; launched "
            + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, eval_counts)))
        if not 0.0 <= metrics.get("accuracy", -1.0) <= 1.0 or eval_counts != EVAL_COUNTS:
            raise AssertionError(f"evaluate: {metrics}, launch counts {eval_counts} != {EVAL_COUNTS}")

        # Restore the epoch's checkpoint (latest and best) over the moved state.
        for best in (False, True):
            trainer.ckpt.restore(state, best=best)
            now = trainer.model.state_dict()
            if state.step != saved_step or any(not torch.equal(now[k].cpu(), v) for k, v in snapshot.items()):
                raise AssertionError(f"checkpoint round trip (best={best}) did not restore step {saved_step}")
        log(f"  checkpoint restore round trip (latest and best) gave back step {saved_step} bit for bit")
        out["train_step"] = {
            "config": "vqa_med_full", "batch": B_TRAIN, "steps": TIMED_TRAIN_STEPS,
            "ms_per_step": step_ms, "examples_per_s": B_TRAIN / (step_ms / 1e3),
            "peak_mem_gib": peak, "losses_repeated_batch": losses, "fit": row, "eval": metrics,
            "launches": dict(zip(KERNELS, counts)), "plain_layernorms": plain_ln,
            "before_k7_ms_per_step": BEFORE_K7_MS["train"], "card": smi,
        }
        del trainer, state, snapshot, batch
    torch.cuda.empty_cache()
    return out


def train_step_vs_cpu(torch, dev, counters):
    """Phase 5, last: one train step's loss and gradients on the card against
    the same step on the CPU (plain twins), same weights and batch, at batch
    64 so that the card's backward goes through K4. Full depth and widths;
    dropout 0, because the two devices' generators draw different masks."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.steps import cross_entropy

    cfg = get_config("vqa_med_full", **{"model.dropout": 0.0})
    model = build_model(cfg.model, device=dev, seed=1)
    log(f"  card vs CPU train step: full vqa_med_full at batch {B_TRAIN}, dropout 0")
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.randint(0, 256, (B_TRAIN, 256, 256, 3)).astype(np.uint8))
    qids = np.zeros((B_TRAIN, cfg.model.max_question_len), np.int64)
    for i in range(B_TRAIN):
        n = rng.randint(3, 16)
        qids[i, :n] = rng.randint(1, cfg.model.bert_vocab_size, n)
    qids = torch.from_numpy(qids)
    labels = torch.from_numpy(rng.randint(1, cfg.model.answer_vocab_size, B_TRAIN).astype(np.int64))

    def loss_and_grads(m, device):
        logits = m(images.to(device), qids.to(device), train=True)
        loss = cross_entropy(logits, labels.to(device))
        loss.backward()
        return loss.item(), {n: p.grad.float().cpu() for n, p in m.named_parameters()}

    torch.cuda.synchronize()
    _zero(counters)
    loss_gpu, g_gpu = loss_and_grads(model, dev)
    counts = [f.launches for f in counters]
    t0 = time.perf_counter()
    loss_cpu, g_cpu = loss_and_grads(cpu_model, "cpu")
    cpu_s = time.perf_counter() - t0
    del model, cpu_model
    torch.cuda.empty_cache()
    # bk's gradient is 0 in exact arithmetic: rounding noise on both sides.
    names = [n for n in g_cpu if not n.endswith("k_proj.bias")]
    flat = lambda g: torch.cat([g[n].flatten() for n in names])
    norms = {n: g_cpu[n].norm().item() for n in names}
    rel = {n: ((g_gpu[n] - g_cpu[n]).norm() / max(norms[n], 1e-30)).item() for n in names}
    # The tensors that carry the update: at least 1% of the largest
    # gradient tensor's norm. Below that sit the q/k projections of the
    # deep BERT and BTIA layers, whose score-path gradient is a difference
    # of nearly equal bf16 terms; their error grows smoothly as their norm
    # falls (an H100 run: 9% at 1.6e-3 of the largest, 83% at 1.6e-5), the
    # signature of rounding, where a faulty kernel would show at every norm.
    big = [n for n in names if norms[n] >= 0.01 * max(norms.values())]
    worst = max(big, key=rel.get)
    res = {
        "loss_card": loss_gpu, "loss_cpu": loss_cpu,
        "grad_norm_card": flat(g_gpu).norm().item(), "grad_norm_cpu": flat(g_cpu).norm().item(),
        "grad_rel_l2": ((flat(g_gpu) - flat(g_cpu)).norm() / flat(g_cpu).norm()).item(),
        "median_rel_l2": float(np.median(list(rel.values()))), "tensors_held": len(big),
        "tensors": len(names), "worst_rel_l2": rel[worst], "worst_param": worst,
        "worst_rel_l2_small": max(rel[n] for n in names if n not in big),
        "cpu_seconds": cpu_s, "launches": dict(zip(KERNELS, counts)),
    }
    log(f"  {json.dumps(res)}")
    # bf16 on both sides, rounded at other places by the kernels and the
    # twins in every layer: the loss within 1%, the gradient's norm within
    # 2% and its relative L2 error within 5%, each tensor held within 10%
    # (an H100 run: 8e-5, 8e-4, 1.1% and median 1.0%).
    if not (abs(loss_gpu - loss_cpu) <= 0.01 * abs(loss_cpu) and res["grad_rel_l2"] <= 0.05
            and abs(res["grad_norm_card"] - res["grad_norm_cpu"]) <= 0.02 * res["grad_norm_cpu"]
            and rel[worst] <= 0.1):
        raise AssertionError(f"card and CPU train steps disagree: {res}")
    if counts != TRAIN_COUNTS:
        raise AssertionError(f"card-vs-CPU step launch counts {counts} != {TRAIN_COUNTS}")
    return res


def wide_heads_phase(torch, dev, smi, counters, heads_list=WIDE_HEADS, expected=None, phase="5b", timed_steps=0):
    """Phase 5b: full-width vqa_med_full with model.num_heads 6, 4 and 3, so
    that its 4 BTIA layers and its AD head run at head widths 128, 192 and
    256 (BERT and ViT-B keep 12 heads of 64). For each, through the Trainer
    on a synthetic corpus: one train step at batch 64 with every counter set
    to 0 just before and read just after (K1 20, K3 13, K4 20: 8 of the K1
    sites, the AD head's K3 call and 8 of the K4 calls at the wide width);
    then one eval forward of a batch on the card against the same model and
    weights on the CPU on its first rows, logits within a tenth of the
    largest. Phase 5d runs the same at model.num_heads 2 (head width 384,
    ``WIDE_KERNEL_COUNTS``: those sites on the wide-head kernel), its counts
    K1..K8 and NEW_KERNELS, and times `timed_steps` train steps and eval
    forwards after the counted ones (host clock, ending in a synchronize)."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.synthetic import generate_synthetic_vqa_med
    from btia_tpu_torch.train.trainer import Trainer, batch_to_device

    train_expected, eval_expected = expected or (TRAIN_COUNTS, EVAL_COUNTS)
    names = KERNELS + NEW_KERNELS if len(counters) > len(KERNELS) else KERNELS
    results = {}
    for heads in heads_list:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_heads_") as tmp:
            root = Path(tmp) / "vqa_med"
            generate_synthetic_vqa_med(root, num_images=32)  # 64 pairs per split: one batch
            cfg = get_config("vqa_med_full", **{"data.data_dir": str(root), "model.num_heads": heads,
                                                "train.warmup_steps": 2})
            hw = cfg.model.hidden_dim // heads
            what = f"num_heads={heads}"
            trainer = Trainer(cfg, Path(tmp) / "run", device=dev)
            log(f"phase {phase}: vqa_med_full with model.{what}: BTIA and the AD head at {heads} heads of "
                f"{hw}, BERT and ViT-B at 12 of 64")
            batch = batch_to_device(next(iter(trainer.data.iterator("train", seed=0))), dev)
            torch.cuda.synchronize()
            _zero(counters)
            _, m = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            counts = [f.launches for f in counters]
            loss = float(m["loss"])
            log(f"  one train step at batch {B_TRAIN}: loss {loss:.5f}; launched "
                + ", ".join(f"{k} {c}" for k, c in zip(names, counts)))
            if counts != train_expected or not np.isfinite(loss):
                raise AssertionError(f"{what} train step: loss {loss}, launch counts {counts} != {train_expected}")
            timed = {}

            model = trainer.model
            model.eval()
            images, qids = batch["images"], batch["question_ids"]
            with torch.inference_mode():
                _zero(counters)
                out_gpu = model(images, qids, train=False)
                torch.cuda.synchronize()
                eval_counts = [f.launches for f in counters]
                if timed_steps:  # host clock, ending in a synchronize
                    t0 = time.perf_counter()
                    for _ in range(timed_steps):
                        model(images, qids, train=False)
                    torch.cuda.synchronize()
                    timed["eval_ms_per_forward"] = (time.perf_counter() - t0) / timed_steps * 1e3
                cpu_model = copy.deepcopy(model).to("cpu")
                out_cpu = cpu_model(images[:2].cpu(), qids[:2].cpu(), train=False)
            del cpu_model
            err = (out_gpu[:2].float().cpu() - out_cpu.float()).abs().max().item()
            scale = out_cpu.float().abs().max().item()
            res = {"config": f"vqa_med_full + model.{what}", "head_width": hw, "train_loss": loss,
                   "train_launches": dict(zip(names, counts)), "eval_launches": dict(zip(names, eval_counts)),
                   "eval_card_vs_cpu_max_abs_err": err, "eval_max_logit": scale, **timed, "card": smi}
            log(json.dumps({f"head_width_{hw}": res}))
            if not bool(torch.isfinite(out_gpu).all()) or not err <= 0.1 * scale:
                raise AssertionError(f"{what} eval: card and CPU logits disagree: {err} > {0.1 * scale}")
            if eval_counts != eval_expected:
                raise AssertionError(f"{what} eval launch counts {eval_counts} != {eval_expected}")
            if timed_steps:  # train steps on the same batch, after the eval check
                model.train()
                t0 = time.perf_counter()
                for _ in range(timed_steps):
                    trainer.train_step(trainer.state, batch)
                torch.cuda.synchronize()
                res["train_ms_per_step"] = (time.perf_counter() - t0) / timed_steps * 1e3
                log(f"  {timed_steps} train steps {res['train_ms_per_step']:.2f} ms a step, eval forwards "
                    f"{res['eval_ms_per_forward']:.2f} ms a forward at batch {B_TRAIN} ({smi})")
            results[hw] = res
            del trainer, model, batch, out_gpu
        torch.cuda.empty_cache()
    return results


def pathvqa_phase(torch, dev, smi, counters):
    """Phase 5c: full-width pathvqa_vit (ViT-B/16, BERT-base, 2 BTIA layers,
    an AD head of 256 answer queries over 4096 answers) through the Trainer
    on a synthetic PathVQA corpus of 64 pairs a split (one batch of 64),
    train.steps_per_call cut from 8 to 1 so that train_step is one step: one
    train step with every counter set to 0 just before and read just after
    (PATHVQA_TRAIN_COUNTS), then one eval forward of the batch on the card
    (PATHVQA_EVAL_COUNTS) against the same model and weights on the CPU on
    its first two rows, logits within a tenth of the largest."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.synthetic import generate_synthetic_pathvqa
    from btia_tpu_torch.train.trainer import Trainer, batch_to_device

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pathvqa_") as tmp:
        root = Path(tmp) / "pathvqa"
        generate_synthetic_pathvqa(root, num_images=32)  # 64 pairs per split: one batch
        cfg = get_config("pathvqa_vit", **{"data.data_dir": str(root), "train.steps_per_call": 1,
                                           "train.warmup_steps": 2})
        trainer = Trainer(cfg, Path(tmp) / "run", device=dev)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f"phase 5c: pathvqa_vit ({n_params / 1e6:.1f} M params; {cfg.model.btia_layers} BTIA layers, "
            f"{cfg.model.num_answer_queries} answer queries over {cfg.model.answer_vocab_size} answers), "
            f"batch {cfg.train.batch_size}, steps_per_call cut to 1")
        batch = batch_to_device(next(iter(trainer.data.iterator("train", seed=0))), dev)
        torch.cuda.synchronize()
        _zero(counters)
        _, m = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        counts = [f.launches for f in counters]
        loss = float(m["loss"])
        log(f"  one train step at batch {batch['images'].shape[0]}: loss {loss:.5f}; launched "
            + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts)))
        if counts != PATHVQA_TRAIN_COUNTS or not np.isfinite(loss):
            raise AssertionError(f"pathvqa_vit train step: loss {loss}, launch counts {counts} "
                                 f"!= {PATHVQA_TRAIN_COUNTS}")
        model = trainer.model
        model.eval()
        images, qids = batch["images"], batch["question_ids"]
        with torch.inference_mode():
            _zero(counters)
            out_gpu = model(images, qids, train=False)
            torch.cuda.synchronize()
            eval_counts = [f.launches for f in counters]
            cpu_model = copy.deepcopy(model).to("cpu")
            out_cpu = cpu_model(images[:2].cpu(), qids[:2].cpu(), train=False)
        del cpu_model
        err = (out_gpu[:2].float().cpu() - out_cpu.float()).abs().max().item()
        scale = out_cpu.float().abs().max().item()
        res = {"config": "pathvqa_vit + train.steps_per_call=1", "train_loss": loss,
               "train_launches": dict(zip(KERNELS, counts)), "eval_launches": dict(zip(KERNELS, eval_counts)),
               "eval_card_vs_cpu_max_abs_err": err, "eval_max_logit": scale, "card": smi}
        log(json.dumps({"pathvqa_vit": res}))
        if not bool(torch.isfinite(out_gpu).all()) or not err <= 0.1 * scale:
            raise AssertionError(f"pathvqa_vit eval: card and CPU logits disagree: {err} > {0.1 * scale}")
        if eval_counts != PATHVQA_EVAL_COUNTS:
            raise AssertionError(f"pathvqa_vit eval launch counts {eval_counts} != {PATHVQA_EVAL_COUNTS}")
        del trainer, model, batch, out_gpu
    torch.cuda.empty_cache()
    return res


def serve_step_fn(torch, dev, model, host_imgs, host_qids, limit):
    """The bench-shaped serve step on `model`: batch i of the two host
    batches, encode_image -> answer_questions -> top-5, fetched to the host."""
    from btia_tpu_torch.ops.answers import topk_real

    @torch.inference_mode()
    def step(i):
        imgs = torch.from_numpy(host_imgs[i % 2]).to(dev)
        qids = torch.from_numpy(host_qids[i % 2]).to(dev)
        vals, idx = topk_real(model.answer_questions(model.encode_image(imgs), qids), 5, limit)
        return vals.cpu().numpy(), idx.cpu().numpy()

    return step


def int8_serve_phase(torch, dev, smi, bf16_model, host_imgs, host_qids, counters):
    """Phase 4b: full-width streaming_vitl with int8_ffn, the same seeded
    weights as the bf16 model: one 16 x 128 step with every counter set to
    0 just before and read just after (K1 20, K2 1, K3 24, K7 74, K8 90, the
    others 0), its LayerNorms held as phase 4's (``check_layernorm_road``),
    timed steps (which must prepare no weight again: ``prepare_once.builds``
    unchanged), the step on the plain LayerNorms timed and its logits
    against K7's, logits against the same model on the CPU, and top-1
    agreement with the bf16 model (reported, not held)."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.ops import gemm as G
    from btia_tpu_torch.ops.answers import argmax_real

    cfg = get_config("streaming_vitl", **{"model.int8_ffn": True})
    model = build_model(cfg.model, device=dev, seed=0)
    if not model.policy.int8:
        raise AssertionError("int8_ffn did not turn the int8 policy on")
    limit = cfg.model.answer_vocab_size
    step = serve_step_fn(torch, dev, model, host_imgs, host_qids, limit)
    torch.cuda.synchronize()
    _zero(counters)
    vals, _ = step(0)
    torch.cuda.synchronize()
    counts = [f.launches for f in counters]
    log("phase 4b: one int8 serve step launched " + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts)))
    if counts != INT8_COUNTS:
        raise AssertionError(f"int8 serve-step launch counts {counts} != {INT8_COUNTS}")
    if vals.shape != (B_IMG, N_Q, 5) or not np.isfinite(vals).all():
        raise AssertionError("int8 serve step: bad top-k")
    check_layernorm_road(torch, step, "int8 serve step")
    # The first step prepared every weight (K8's 90 int8 weights among them);
    # the timed steps prepare nothing again.
    builds = G.prepare_once.builds
    step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        step(i)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    rebuilt = G.prepare_once.builds - builds
    if rebuilt:
        raise AssertionError(f"int8 serve steps after the first prepared {rebuilt} weight sets again")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if "--profile" in sys.argv[1:]:
        profile_step(torch, lambda: step(0), smi, "int8_serve_step")

    # The same step with the LayerNorms on the plain formula, the road before
    # K7: timed, and its logits against the default's.
    ab = k7_vs_plain_ms(torch, lambda: step(0), TIMED_STEPS)
    with torch.inference_mode():
        imgs, qids = torch.from_numpy(host_imgs[0]).to(dev), torch.from_numpy(host_qids[0]).to(dev)
        logits8 = model.answer_questions(model.encode_image(imgs), qids)
        with plain_layernorms():
            ln_err = (model.answer_questions(model.encode_image(imgs), qids) - logits8).abs().max().item()
        top8 = argmax_real(logits8, limit)
        top16 = argmax_real(bf16_model.answer_questions(bf16_model.encode_image(imgs), qids), limit)
        agree = (top8 == top16).float().mean().item()
        # The same int8 model on the CPU (plain twins) as the reference.
        ref = copy.deepcopy(model).to("cpu")
        img1, ids = imgs[:1].cpu(), qids[:1, :2].cpu()
        out_gpu = model.answer_questions(model.encode_image(img1.to(dev)), ids.to(dev)).cpu()
        out_cpu = ref.answer_questions(ref.encode_image(img1), ids)
        del ref
    err, scale = (out_gpu - out_cpu).abs().max().item(), out_cpu.abs().max().item()
    res = {
        "config": "streaming_vitl + model.int8_ffn", "images": B_IMG, "questions_per_image": N_Q,
        "steps": TIMED_STEPS, "ms_per_step": step_ms, "pairs_per_s": B_IMG * N_Q / (step_ms / 1e3),
        "peak_mem_gib": peak, "launches": dict(zip(KERNELS, counts)),
        "weight_sets_prepared_in_timed_steps": rebuilt,
        "top1_agreement_with_bf16": agree, "card_vs_cpu_max_abs_err": err,
        "card_vs_cpu_max_logit": scale,
        "plain_layernorms": {"ms_per_step": ab["plain"], "k7_ms_per_step": ab["k7"], "turns": ab["turns"],
                             "logits_max_abs_err_vs_k7": ln_err, "max_logit": logits8.abs().max().item()},
        "before_k7_ms_per_step": BEFORE_K7_MS["int8_serve"], "card": smi,
    }
    log(json.dumps({"int8_serve_step": res}))
    if not ln_err <= 0.1 * res["plain_layernorms"]["max_logit"]:
        raise AssertionError(f"int8: logits on K7 and on the plain LayerNorms differ by {ln_err}")
    # As phase 3: bf16 roundings differ between the kernels and the twins
    # in every layer, and a rounding can move an int8 quantization step.
    if not err <= 0.1 * scale:
        raise AssertionError(f"int8: card and CPU logits disagree: {err} > {0.1 * scale}")
    return model, cfg, counts, res


# Template questions for the streaming phase: radiology-style VQA stems
# over organs, findings and sides; requests draw from them with repeats.
_STEMS = ("is there a {f} in the {o}", "is the {o} normal", "what abnormality is seen in the {o}",
          "which side is the {f} on", "does the {o} show {f}", "is the {f} in the {s} {o}")
_ORGANS = ("lung", "liver", "kidney", "brain", "heart", "spleen")
_FINDINGS = ("mass", "fracture", "effusion", "lesion", "nodule", "cyst")


def streaming_phase(torch, dev, smi, model, cfg):
    """Phase 4c: StreamingServer over the int8 model, B 16, Q 128, top-5,
    two decode threads, in four modes: plain, dedup_questions, pack_pairs
    with pair_budget B*Q/2, and max_wait_ms on a sparse trickle. Each mode
    must answer every good request exactly once, record exactly the corrupt
    one, and agree with Predictor on a sample of requests."""
    import io
    import itertools

    import numpy as np
    from PIL import Image

    from btia_tpu_torch.data.dicom import write_dicom
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.infer.streaming import StreamingServer
    from btia_tpu_torch.ops.answers import argmax_real, real_limit

    corpus = sorted({t.format(o=o, f=f, s=sd) for t, o, f, sd in itertools.product(
        _STEMS, _ORGANS, _FINDINGS, ("left", "right"))})
    pred = Predictor(model, None, WordPieceTokenizer.toy_vocab(corpus),
                     AnswerVocab([f"answer {i}" for i in range(300)]), cfg, device=dev)
    rng = np.random.RandomState(5)
    S = pred.ingest_size

    def jpeg(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    pools = {
        "ingest_array": [rng.randint(0, 256, (S, S, 3)).astype(np.uint8) for _ in range(4)],
        "offsize_array": [rng.randint(0, 256, (300 + 40 * i, 420, 3)).astype(np.uint8) for i in range(4)],
        "jpeg_bytes": [jpeg(rng.randint(0, 256, (512, 400, 3)).astype(np.uint8)) for _ in range(4)],
        "dicom_bytes": [write_dicom(None, (rng.rand(256, 256) * 3000).astype(np.uint16)) for _ in range(4)],
    }
    kinds = list(pools)
    corrupt = 7
    reqs = []
    for i in range(40):
        if i == corrupt:
            blob = pools["dicom_bytes"][0]
            reqs.append((blob[: len(blob) // 2], ["is the lung normal"]))
            continue
        n = int(rng.randint(1, N_Q + 1))
        reqs.append((pools[kinds[i % 4]][(i // 4) % 4], [corpus[j] for j in rng.randint(0, len(corpus), n)]))
    good = {i: len(q) for i, (_, q) in enumerate(reqs) if i != corrupt}

    def trickle(n_req=9, gap_s=0.25):
        for r in reqs[:n_req]:
            yield r
            time.sleep(gap_s)

    limit = real_limit(len(pred.answer_vocab), cfg.model.answer_vocab_size)
    sample = [0, 5, 10, 19]  # an ingest array, an off-size array, JPEG and DICOM bytes
    refs = {i: pred.predict_batch(*reqs[i]) for i in sample}
    modes = (
        ("plain", {}, lambda: iter(reqs), good),
        ("dedup_questions", {"dedup_questions": True}, lambda: iter(reqs), good),
        ("pack_pairs", {"pack_pairs": True, "pair_budget": B_IMG * N_Q // 2}, lambda: iter(reqs), good),
        ("max_wait_ms", {"max_wait_ms": 50}, trickle, {i: n for i, n in good.items() if i < 9}),
    )
    out = {}
    for mode, kw, source, expected in modes:
        server = StreamingServer(pred, image_batch=B_IMG, questions_per_image=N_Q, topk=5,
                                 decode_threads=2, **kw)
        warm_s = server.warmup()
        got = {}
        for idx, (vals, ids), n in server.serve(source()):
            if idx in got:
                raise AssertionError(f"stream {mode}: request {idx} answered twice")
            got[idx] = (vals[:n], ids[:n], n)
        if set(got) != set(expected) or any(got[i][2] != n for i, n in expected.items()):
            raise AssertionError(f"stream {mode}: answered {sorted(got)} with counts "
                                 f"{[got[i][2] for i in sorted(got)]}, expected {expected}")
        if [i for i, _ in server.errors] != [corrupt]:
            raise AssertionError(f"stream {mode}: errors {server.errors}, expected request {corrupt}")
        errs, top1 = [], []
        for i in sample:
            if i not in got:
                continue
            vals, ids, n = got[i]
            logits = refs[i]
            # Same device and kernels, other batch shapes (a library GEMM may
            # take another algorithm): the values of the stream's top-5
            # answers in the Predictor's logits, within 1 % of the largest
            # logit (an H100 run: 2.5e-6 at a largest logit of ~2).
            err = float(np.abs(np.take_along_axis(logits, ids, -1) - vals).max())
            if not err <= 0.01 * float(np.abs(logits).max()):
                raise AssertionError(f"stream {mode}: request {i} disagrees with Predictor by {err}")
            errs.append(err)
            top1.append(float((ids[:, 0] == argmax_real(logits, limit)).mean()))
        out[mode] = {
            "requests": len(got), "pairs": server.pairs_processed,
            "pairs_per_s": server.pairs_per_second, "wall_s": server.wall_seconds,
            "warmup_s": warm_s, "latency": server.latency_summary(),
            "vs_predictor_max_abs_err": max(errs), "vs_predictor_top1": float(np.mean(top1)),
        }
        log(f"  stream {mode}: {json.dumps(out[mode])}")
    log(json.dumps({"stream": {"config": "streaming_vitl + model.int8_ffn", "image_batch": B_IMG,
                               "questions_per_image": N_Q, "topk": 5, "decode_threads": 2,
                               "modes": out, "card": smi}}))
    return out


def new_counters():
    """The f32 and wide-head kernels' launch counters (NEW_KERNELS)."""
    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import gemm as G

    return (A.simt_attention, G.gemm_f32, A.wide_attention)


def _simt_case(torch, dev, name, entry, dims, dt, g):
    """(kernel, plain twin, SDPA yardstick, flops, bytes) of one attention
    call through an entry's CUDA half, with its operands."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import bicross as BX
    from btia_tpu_torch.ops import fused_attn as FA

    B, Sq, Sk, H, D = (dims[k] for k in ("B", "Sq", "Sk", "H", "D"))
    HD = H * D
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    mask = _question_mask(torch, dev, g, B, Sk) if dims.get("masked") else None
    heads = lambda x, S: x.reshape(-1, S, H, D).transpose(1, 2)  # (B, S, H*D) -> (B, H, S, D)
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    ops = 4 * B * H * Sq * Sk * D
    if entry == "core":
        shared = dims.get("shared", False)
        q = r(Sq if shared else B * Sq, HD)
        kv = r(B * Sk, 2 * HD)
        qv = q[None].expand(B, Sq, HD) if shared else q.view(B, Sq, HD)
        k, v = kv[:, :HD].reshape(B, Sk, HD), kv[:, HD:].reshape(B, Sk, HD)
        cm = torch.ones(B, Sk, device=dev) if mask is None else mask.float()
        kernel = lambda: FA._core_cuda(q, kv, mask, B, Sq, Sk, H, q_shared=shared)
        plain = lambda: A.attend_log2(qv, k, v, cm, H).reshape(B * Sq, HD)
        library = lambda: F.scaled_dot_product_attention(heads(qv, Sq), heads(k, Sk), heads(v, Sk), sdpa_mask)
        return kernel, plain, library, ops, nbytes(q, kv, mask) + B * Sq * HD * q.element_size()
    if entry in ("k3", "k4"):
        q, k, v = r(B, Sq, HD), r(B, Sk, HD), r(B, Sk, HD)
        library = lambda: F.scaled_dot_product_attention(heads(q, Sq), heads(k, Sk), heads(v, Sk), sdpa_mask)
        if entry == "k3":
            kernel = lambda: A._bshd_flash_cuda(q, k, v, mask, H)
            plain = lambda: A._bshd_flash_plain(q, k, v, mask, H)
        else:
            cm = torch.ones(B, Sk, device=dev) if mask is None else mask.float()
            kernel = lambda: A._fanout_cuda(q, k, v, cm, H)
            plain = lambda: A._fanout_plain(q, k, v, cm, H)
        return kernel, plain, library, ops, nbytes(q, k, v, mask, q)
    if entry == "k5":  # mha_bshd's long road: (B, S, H, D) buffers as (B, H, S, D) views
        q, k, v = (r(B, S, H, D).transpose(1, 2) for S in (Sq, Sk, Sk))
        return (lambda: A._mha_bhsd_cuda(q, k, v, mask), lambda: A._mha_bhsd_plain(q, k, v, mask),
                lambda: F.scaled_dot_product_attention(q, k, v, sdpa_mask), ops, nbytes(q, k, v, mask, q))
    qi, ki, vi = (r(B, H, Sq, D) for _ in range(3))  # k6: both directions
    qt, kt, vt = (r(B, H, Sk, D) for _ in range(3))
    library = lambda: (F.scaled_dot_product_attention(qi, kt, vt, sdpa_mask),
                       F.scaled_dot_product_attention(qt, ki, vi))
    return (lambda: BX._bicross_cuda(qi, ki, vi, qt, kt, vt, mask),
            lambda: BX._bicross_plain(qi, ki, vi, qt, kt, vt, mask), library, 2 * ops,
            nbytes(qi, ki, vi, qt, kt, vt, mask, qi, qt))


def _simt_row(torch, name, kernel, plain, library, flops, nbytes_, dt, iters=5):
    """Hold a CUDA-core kernel against its twin (f32: 1e-4 of the largest
    magnitude, one f32 sum order apart; bf16: 1/32 of it, as phase 2) and
    time it, the twin and the library call beside the bound at the card's
    peak for the operands' type."""
    out = _flat_f32(kernel())
    torch.cuda.synchronize()
    ref = _flat_f32(plain())
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    tol = (1e-4 if dt == torch.float32 else 1 / 32) * scale
    finite = bool(torch.isfinite(out).all())
    del out, ref
    row = {"dtype": str(dt).replace("torch.", ""), "max_abs_err": err, "tol": tol, "max_ref": scale,
           "ms": cuda_time_ms(kernel, iters), "plain_ms": cuda_time_ms(plain, 2),
           "library_ms": cuda_time_ms(library, iters)}
    peak = PEAK_F32_SIMT if dt == torch.float32 else PEAK_BF16_FLOPS
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes_, peak)
    log(f"  {name}: err {err:.4g} (tol {tol:.4g}) kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if not (finite and err <= tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain twin: {err} > {tol} (finite {finite})")
    return row


def _wide_capture(torch, kernel):
    """Run kernel() (an entry's CUDA half on the wide route) once, recording
    what its launcher packed (``ops/attention.py::attend_args``, with the
    tensors the pointers name) and the C call it made. Returns (the C call
    alone, a function that repacks the same problems, the stream lookup on
    the call's first operand, the problems)."""
    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.ops import attention as A

    rec, real_args, real_lib_fn = {}, A.attend_args, _native.lib
    real_lib = real_lib_fn()

    def spy_args(problems, dw):
        rec["problems"], rec["dw"] = problems, dw
        rec["packed"] = real_args(problems, dw)
        return rec["packed"]

    class SpyLib:
        def __getattr__(self, name):
            return getattr(real_lib, name)

        def btia_attn_wide(self, *a):
            rec["call"] = a
            return real_lib.btia_attn_wide(*a)

    A.attend_args, _native.lib = spy_args, (lambda: SpyLib())
    try:
        rec["out"] = kernel()
    finally:
        A.attend_args, _native.lib = real_args, real_lib_fn
    torch.cuda.synchronize()
    t0 = rec["packed"][3][0]
    return (lambda: real_lib.btia_attn_wide(*rec["call"]), lambda: real_args(rec["problems"], rec["dw"]),
            lambda: _native.stream(t0), rec["problems"])


def _host_us(torch, fn, n=200):
    """Host microseconds a call of fn over n calls (launches queue on the
    card meanwhile; the synchronize after them is not counted)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def _operand_builders(entry, problems):
    """Two ways for an entry to hand its launcher the operands of one call,
    from the operand specs it handed (``ops/attention.py::operand``): the
    (B, H, S, D) views a launcher of views needs (K1/K2's core:
    ``as_strided`` on the q, [k|v] and output buffers; K3/K4: ``unflatten``
    and ``transpose`` of the (B, S, H*D) tensors), and the specs, built as
    the entry builds them. None for K5 and K6, whose operands are the
    caller's own views."""
    if entry not in ("core", "k3", "k4"):
        return None
    ops = [x for p in problems for x in p[:4]]
    if entry == "core":
        return (lambda: [t.as_strided(s, st, t.storage_offset() + off) for t, off, s, st in ops],
                lambda: [(t, off, s, st) for t, off, s, st in ops])
    H, D = ops[0][2][1], ops[0][2][3]

    def spec(t):  # ops/attention.py::_attend_bshd's heads()
        sb, ss, sc = t.stride()
        return t, 0, (t.shape[0], H, t.shape[1], D), (sb, D * sc, ss, sc)

    return (lambda: [x[0].unflatten(2, (H, -1)).transpose(1, 2) for x in ops],
            lambda: [spec(x[0]) for x in ops])


def _wide_entry_times(torch, name, entry, kernel, wrapper_ms):
    """The wide kernel's C entry alone on the operands its launcher packed
    (CUDA events), the host's share of the wrapper (wrapper - C entry), and
    the host time a call, line by line (host clock): the whole entry, the
    packing (``attend_args``), the C call (its tensor maps and launch), the
    stream lookup, and the rest (the entry's own checks, output and operand
    specs); within the rest, building the call's specs against building
    views of the same operands (``_operand_builders``)."""
    from btia_tpu_torch.ops import _native

    c_call, pack, stream, problems = _wide_capture(torch, kernel)
    code = c_call()
    torch.cuda.synchronize()
    _native.check(code, f"{name}: btia_attn_wide")
    c_ms = cuda_time_ms(c_call, 10)
    host = {"entry": _host_us(torch, kernel), "attend_args": _host_us(torch, pack),
            "c_call": _host_us(torch, c_call), "stream": _host_us(torch, stream)}
    host["rest"] = host["entry"] - host["attend_args"] - host["c_call"] - host["stream"]
    builders = _operand_builders(entry, problems)
    if builders is not None:
        host["views"], host["specs"] = (_host_us(torch, b) for b in builders)
    log(f"    C entry {c_ms:.4f} ms; wrapper - C entry {1e3 * (wrapper_ms - c_ms):.1f} us; host us a call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    return {"c_entry_ms": c_ms, "host_share_us": 1e3 * (wrapper_ms - c_ms), "host_us": host}


def wide_ptxas():
    """ptxas's registers, spills and C75xx warnings for each instance of
    the wide kernel (attn_wide_kernel<slice width, cluster size, zero-rows
    mask>), from the build's log."""
    from btia_tpu_torch.ops import _native

    text = _native.ptxas_log("attn_wide.cu")
    out, cur = {}, None

    def instance(mangled):
        t = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", mangled)
        return f"attn_wide_kernel<{t.group(1)}, {t.group(2)}, {t.group(3)}>" if t else mangled

    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = instance(m.group(1)) if "attn_wide_kernel" in m.group(1) else None
            if cur:
                out.setdefault(cur, {"warnings": []})
            continue
        m = re.search(r"C75\d\d.*?(_Z\S*attn_wide_kernel\S*)", line)
        if m:  # ptxas names the function a serialisation warning is about
            out.setdefault(instance(m.group(1).strip("'")), {"warnings": []})["warnings"].append(line.strip())
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    for k, v in out.items():
        log(f"  ptxas {k}: {v.get('registers')} registers, spill stores {v.get('spill_stores')} B, "
            f"loads {v.get('spill_loads')} B{'; ' + ' | '.join(v['warnings']) if v['warnings'] else ''}")
    if not out:
        log("  ptxas: no log of attn_wide.cu (the library was not built by this checkout's build)")
    return out


def wide_cases():
    """Phase 2c's bf16 cases of the wide-head kernel: (name, entry, dims)."""
    cases = []
    for D, H in WIDE_D:
        for entry, (B, Sq, Sk) in SIMT_WIDE_SHAPES.items():
            cases.append((f"{entry}_bf16_d{D}", entry, dict(B=B, Sq=Sq, Sk=Sk, H=H, D=D, masked=entry != "k3")))
    return cases + [WIDE_ODD]


def check_simt(torch, dev):
    """Phase 2c: the f32 attention kernel (CUDA cores) through each entry's
    CUDA half (K1/K2's core, K3, K4, K5, K6) at the fp32 path's shapes and
    at D 256, the wide-head kernel (tensor cores) through the same halves in
    bf16 at head widths 300 to 1024, and the f32 GEMM at the fp32 forwards'
    projection shapes, each against its twin and timed beside SDPA or
    ``F.linear`` (TF32 off) and the bound. Returns the f32 attention's,
    the wide kernel's and the GEMM's rows, and each attention case's launch
    route (the counter its call moved)."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops import attention as A
    from btia_tpu_torch.ops import gemm as G

    g = torch.Generator(device=dev).manual_seed(9)
    attn, wide, gemm = {}, {}, {}
    log("phase 2c: the f32 (CUDA-core) and wide-head (tensor-core) kernels vs their twins")
    cases = [(n, e, d, torch.float32) for n, e, d in SIMT_F32_CASES]
    cases += [(n, e, d, torch.bfloat16) for n, e, d in wide_cases()]
    for name, entry, dims, dt in cases:
        kernel, plain, library, flops, nb = _simt_case(torch, dev, name, entry, dims, dt, g)
        counter = A.simt_attention if dt == torch.float32 else A.wide_attention
        before = counter.launches
        kernel()
        torch.cuda.synchronize()
        if counter.launches != before + 1:
            raise AssertionError(f"{name}: the call did not launch {counter.__name__}")
        row = {"entry": entry, **dims, **_simt_row(torch, name, kernel, plain, library, flops, nb, dt)}
        if dt == torch.bfloat16:
            row.update(_wide_entry_times(torch, name, entry, kernel, row["ms"]))
        (attn if dt == torch.float32 else wide)[name] = row
        del kernel, plain, library
        torch.cuda.empty_cache()
    assert torch.backends.cuda.matmul.allow_tf32 is False  # the yardstick in full f32
    for name, M, K, N, rr in GEMM_F32_SITES:
        a = torch.randn(M, K, generator=g, device=dev)
        w = torch.randn(K, N, generator=g, device=dev) / K**0.5
        b = torch.randn(N, generator=g, device=dev)
        res = torch.randn(rr, N, generator=g, device=dev) if rr else None
        kernel = lambda: G.gemm_f32(a, w, b, res, rr)
        plain = lambda: a @ w + b + (0 if res is None else res)
        wt = w.t().contiguous()
        library = lambda: F.linear(a, wt, b)
        row = _simt_row(torch, f"gemm_f32 {name} {M}x{K}x{N}", kernel, plain, library, 2 * M * N * K,
                        nbytes(a, w, b, res) + M * N * 4, torch.float32, iters=10)
        gemm[name] = {"M": M, "K": K, "N": N, "residual_rows": rr, "block_tile": G.GEMM_F32_TILES[G.gemm_f32_tile(M, N)], **row}
    return attn, wide, gemm


def _lstm_qids(rng, shape, vocab):
    """Right-padded question rows of 4..32 real tokens."""
    import numpy as np

    ids = np.zeros((*shape, SEQ), np.int64)
    flat = ids.reshape(-1, SEQ)
    for i in range(flat.shape[0]):
        n = rng.randint(4, SEQ + 1)
        flat[i, :n] = rng.randint(1, vocab, n)
    return ids


def _counts(counters):
    return [f.launches for f in counters]


def _card_vs_cpu(torch, model, fn, what, tol_frac):
    """fn(model, device) on the card and on a CPU copy of the model; the
    logits within tol_frac of the CPU's largest. Returns (err, scale)."""
    dev = next(model.parameters()).device
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        out_gpu = fn(model, dev).float().cpu()
        out_cpu = fn(cpu_model, "cpu").float()
    del cpu_model
    err, scale = (out_gpu - out_cpu).abs().max().item(), out_cpu.abs().max().item()
    log(f"  {what}: card vs CPU max abs err {err:.4g} at max |logit| {scale:.4g} (tol {tol_frac} x)")
    if not (bool(torch.isfinite(out_gpu).all()) and err <= tol_frac * scale):
        raise AssertionError(f"{what}: card and CPU logits disagree: {err} > {tol_frac * scale}")
    return err, scale


def _step_on(torch, dev, name, batch_fn, counters, mixed, bn_running=False):
    """One train step (dropout 0: the two devices' generators draw other
    masks) of `name` under the bf16 (mixed) or fp32 policy on the card and
    on a CPU copy, same weights and batch of 64; with `bn_running` the image
    encoder's BatchNorms normalise by their running statistics. Under fp32
    the step runs a second time on a CPU copy with every weight one f32 ulp
    away (the witness of how far rounding alone moves the gradients).
    cuDNN's global TF32 setting is left at PyTorch's default (on) for the
    step: the fp32 convolutions turn it off themselves. Under fp32 on
    running statistics the card runs the step once more with the encoder's
    convolutions as plain ``F.conv2d`` under that setting, in TF32: the
    yardstick the encoder's bound must reject. Returns the card's launch
    counts and, per device, the loss, the gradients and the BatchNorm
    running statistics after the step."""
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.steps import cross_entropy

    cfg = get_config(name, **{"model.dropout": 0.0, "model.mixed_precision": mixed})
    model = build_model(cfg.model, device=dev, seed=1)
    cpu_model = copy.deepcopy(model).to("cpu")
    images, qids, labels = batch_fn(cfg)

    def run(m, device):
        if bn_running:  # the encoder called as in eval, the rest in train mode
            enc = m.image_encoder
            enc.forward = lambda x, drop=None, train=False, f=enc.forward: f(x, drop, False)
        logits = m(images.to(device), qids.to(device), train=True)
        loss = cross_entropy(logits, labels.to(device))
        loss.backward()
        return {"loss": loss.item(), "grads": {n: p.grad.float().cpu() for n, p in m.named_parameters()},
                "stats": {n: b.float().cpu() for n, b in m.named_buffers()}}

    witness_model = None
    if not mixed:
        witness_model = copy.deepcopy(cpu_model)
        with torch.no_grad():
            for p in witness_model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    torch.cuda.synchronize()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _zero(counters)
        card = run(model, dev)
        counts = _counts(counters)
        if not mixed and bn_running:
            import torch.nn.functional as F

            from btia_tpu_torch.models import resnet

            model.zero_grad(set_to_none=True)
            resnet._F32Conv.apply = staticmethod(lambda x, w, s, p: F.conv2d(x, w, stride=s, padding=p))
            try:
                card["tf32_yardstick"] = run(model, dev)
            finally:
                del resnet._F32Conv.apply  # back to torch.autograd.Function's
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    cpu = run(cpu_model, "cpu")
    cpu["seconds"] = time.perf_counter() - t0
    if witness_model is not None:
        cpu["witness"] = run(witness_model, "cpu")
    del model, cpu_model, witness_model
    torch.cuda.empty_cache()
    return counts, card, cpu


def _cat(d, names):
    import torch

    return torch.cat([d[n].flatten() for n in names])


def _rel_l2(a, b, names):
    x, y = _cat(a, names), _cat(b, names)
    return ((x - y).norm() / y.norm()).item()


def train_step_card_vs_cpu(torch, dev, name, batch_fn, counters, expected):
    """One train step at batch 64 on the card against the CPU, same weights
    and batch, under both policies, each twice: with the image encoder's
    BatchNorms on batch statistics (training as registered) and on their
    running statistics.

    On batch statistics a randomly initialised ResNet-50 amplifies rounding:
    in f32 on the CPU, every weight moved by one ulp (the witness) moves the
    encoder's gradients by as much as the card does (an H100 run: 2.7-2.9 %
    against 2.8-3.0 %). So there the bf16 step is held on its loss (1 %),
    gradient norm (2 %) and BatchNorm statistics (5 % relative L2), and the
    fp32 step's encoder gradients within 5 % and twice the witness.

    Every other gradient is held, and every gradient on running statistics.
    bf16 on running statistics: phase 5's bounds outside the encoder (loss
    1 %, norm 2 %, relative L2 5 %, each tensor above 1 % of the largest
    norm within 10 %; an H100 run: 0.5-1.2 %, worst 3.8 %), the encoder's
    gradients within 5 % (2.6-2.8 %). fp32, with cuDNN's global TF32
    setting on: the loss within 1e-4, the gradient norm within 1e-3
    (relative), the gradients outside the encoder within 1e-3 relative L2
    (3e-5 on batch statistics, 7e-7 on running ones) and each tensor above
    1 % of the largest norm within 1e-2, the BatchNorm statistics within
    1e-4; on running statistics the encoder's gradients within 2e-3 and
    twice the witness (1.9-3.7e-4, witness 6.9e-4), where the same step with
    TF32 convolutions must fall outside (9.7e-3). `expected` is the bf16
    step's counts; the f32 step launches the same entries, K1 and K4 on the
    CUDA-core kernels."""
    res = {}
    for mixed in (True, False):
        for bn_running in (False, True):
            policy, r, ok, counts, want = _step_check(torch, dev, name, batch_fn, counters, expected, mixed,
                                                      bn_running)
            res[policy] = r
            if not ok:
                raise AssertionError(f"{name}: card and CPU {policy} train steps disagree: {r}")
            if counts != want:
                raise AssertionError(f"{name} {policy} card-vs-CPU step launch counts {counts} != {want}")
    return res


def _step_check(torch, dev, name, batch_fn, counters, expected, mixed, bn_running):
    """One step of train_step_card_vs_cpu: (policy, record, within its
    bounds, launch counts, expected counts)."""
    import numpy as np

    counts, card, cpu = _step_on(torch, dev, name, batch_fn, counters, mixed, bn_running)
    names = [n for n in cpu["grads"] if not n.endswith("k_proj.bias")]  # 0 in exact arithmetic
    enc = [n for n in names if n.startswith("image_encoder.")]
    other = [n for n in names if not n.startswith("image_encoder.")]
    norm = lambda d: _cat(d["grads"], names).norm().item()
    stats = sorted(cpu["stats"])
    sizes = {n: cpu["grads"][n].norm().item() for n in other}
    big = [n for n in other if sizes[n] >= 0.01 * max(sizes.values())]
    per = {n: _rel_l2(card["grads"], cpu["grads"], [n]) for n in big}
    r = {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "grad_norm_card": norm(card),
         "grad_norm_cpu": norm(cpu), "grad_rel_l2_image_encoder": _rel_l2(card["grads"], cpu["grads"], enc),
         "grad_rel_l2_rest": _rel_l2(card["grads"], cpu["grads"], other),
         "worst_rel_l2_rest": max(per.values()), "worst_param_rest": max(per, key=per.get),
         "bn_stats_rel_l2": _rel_l2(card["stats"], cpu["stats"], stats), "cpu_seconds": cpu["seconds"],
         "launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
    if "witness" in cpu:
        w = cpu["witness"]
        r["witness_grad_rel_l2_image_encoder"] = _rel_l2(w["grads"], cpu["grads"], enc)
        r["witness_grad_rel_l2_rest"] = _rel_l2(w["grads"], cpu["grads"], other)
    if "tf32_yardstick" in card:
        r["tf32_yardstick_grad_rel_l2_image_encoder"] = _rel_l2(card["tf32_yardstick"]["grads"], cpu["grads"], enc)
    loss_rel = abs(r["loss_card"] - r["loss_cpu"]) / abs(r["loss_cpu"])
    norm_rel = abs(r["grad_norm_card"] - r["grad_norm_cpu"]) / r["grad_norm_cpu"]
    if mixed and not bn_running:
        ok = loss_rel <= 0.01 and norm_rel <= 0.02 and r["bn_stats_rel_l2"] <= 0.05
    elif mixed:
        ok = (loss_rel <= 0.01 and norm_rel <= 0.02 and r["grad_rel_l2_rest"] <= 0.05
              and r["worst_rel_l2_rest"] <= 0.1 and r["grad_rel_l2_image_encoder"] <= 0.05)
    else:
        enc_rel, cap = r["grad_rel_l2_image_encoder"], (2e-3 if bn_running else 0.05)
        ok = (loss_rel <= 1e-4 and norm_rel <= 1e-3 and r["grad_rel_l2_rest"] <= 1e-3
              and r["worst_rel_l2_rest"] <= 1e-2 and r["bn_stats_rel_l2"] <= 1e-4
              and enc_rel <= cap and enc_rel <= 2 * r["witness_grad_rel_l2_image_encoder"])
        if bn_running:
            ok = ok and r["tf32_yardstick_grad_rel_l2_image_encoder"] > cap
    # Under fp32, K1 on its f32 chain (a core and 3 GEMMs a site), K4 in the
    # backward: each a CUDA-core attention launch.
    want = expected if mixed else expected[:len(KERNELS)] + [expected[0] + expected[3], 3 * expected[0], 0]
    policy = ("bf16" if mixed else "fp32") + ("_bn_running" if bn_running else "")
    log(f"  {name} card vs CPU train step, {policy}: {json.dumps(r)}")
    return policy, r, bool(ok and np.isfinite(r["loss_card"])), counts, want


def _bert_qids(rng, shape, vocab):
    return rng.randint(1, vocab, (*shape, SEQ)).astype("int64")


def _serve_phase(torch, dev, smi, model, cfg, vocab, qids_fn, counters, expected, what, timed):
    """One 16 x 128 serve step with every counter set to 0 just before and
    read just after, then (timed) a few steps; the logits of one image's 64
    questions (K1 fused, batch 64) against the CPU within a tenth of the
    largest logit, as phase 3."""
    import numpy as np

    rng = np.random.RandomState(11)
    size = max(256, cfg.model.image_size)
    host_imgs = [rng.randint(0, 256, (B_IMG, size, size, 3)).astype(np.uint8) for _ in range(2)]
    host_qids = [qids_fn(rng, (B_IMG, N_Q), vocab) for _ in range(2)]
    step = serve_step_fn(torch, dev, model, host_imgs, host_qids, cfg.model.answer_vocab_size)
    torch.cuda.synchronize()
    _zero(counters)
    vals, _ = step(0)
    torch.cuda.synchronize()
    counts = _counts(counters)
    log(f"  {what}: one serve step launched " + ", ".join(f"{k} {c}" for k, c in zip(KERNELS + NEW_KERNELS, counts)))
    if counts != expected:
        raise AssertionError(f"{what} serve-step launch counts {counts} != {expected}")
    if vals.shape != (B_IMG, N_Q, 5) or not np.isfinite(vals).all():
        raise AssertionError(f"{what} serve step: bad top-k")
    res = {"launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
    if timed:
        step(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            step(i)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
        res.update({"steps": TIMED_STEPS, "ms_per_step": ms, "pairs_per_s": B_IMG * N_Q / (ms / 1e3),
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        if "--profile" in sys.argv[1:]:
            profile_step(torch, lambda: step(0), smi, f"{what}_serve_step")
        # The same step with the LayerNorms on the plain formula (the road
        # before K7), timed, and its logits against K7's.
        fwd = lambda: model.answer_questions(model.encode_image(torch.from_numpy(host_imgs[0]).to(dev)),
                                             torch.from_numpy(host_qids[0]).to(dev))
        with torch.inference_mode():
            logits = fwd()
            with plain_layernorms():
                ln_err = (fwd() - logits).abs().max().item()
        ab = k7_vs_plain_ms(torch, lambda: step(0), TIMED_STEPS)
        res["plain_layernorms"] = {"ms_per_step": ab["plain"], "k7_ms_per_step": ab["k7"], "turns": ab["turns"],
                                   "logits_max_abs_err_vs_k7": ln_err, "max_logit": logits.abs().max().item()}
        if not ln_err <= 0.1 * res["plain_layernorms"]["max_logit"]:
            raise AssertionError(f"{what}: logits on K7 and on the plain LayerNorms differ by {ln_err}")
    img = torch.from_numpy(host_imgs[0][:1])
    ids = torch.from_numpy(host_qids[0][:1, :64])
    res["card_vs_cpu_max_abs_err"], res["card_vs_cpu_max_logit"] = _card_vs_cpu(
        torch, model, lambda m, d: m.answer_questions(m.encode_image(img.to(d)), ids.to(d)),
        f"{what} serve, 1 image x 64 questions", 0.1)
    return res


def _eval_vs_cpu(torch, dev, model, batch, counters, expected, what):
    """One eval forward of the batch on the card, counted, against the same
    model on the CPU on its first two rows within a tenth of the largest
    logit (phases 5b and 5c)."""
    model.eval()
    images, qids = batch["images"], batch["question_ids"]
    with torch.inference_mode():
        _zero(counters)
        out = model(images, qids, train=False)
        torch.cuda.synchronize()
        counts = _counts(counters)
    if counts != expected or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what} eval forward: launch counts {counts} != {expected} or not finite")
    err, scale = _card_vs_cpu(torch, model, lambda m, d: m(images[:2].to(d), qids[:2].to(d)),
                              f"{what} eval, first 2 of {images.shape[0]} rows", 0.1)
    return {"launches": dict(zip(KERNELS + NEW_KERNELS, counts)), "card_vs_cpu_max_abs_err": err,
            "card_vs_cpu_max_logit": scale}


def vqa_rad_lstm_phase(torch, dev, smi, counters):
    """Phase 6: full-width vqa_rad_lstm (ResNet-50 at 224, bi-LSTM 512,
    hidden 512, 8 heads of 64, 2 BTIA layers, mlp head over 512 answers),
    bf16, seeded random weights: the 16 x 128 serve step (K1 at its 4 BTIA
    sites), timed, also on the plain LayerNorms; a few Predictor requests
    (buckets of at most 8: no K1, K7 14 each);
    one call of its registered 8 scanned train steps at batch 64 through
    Trainer on a synthetic VQA-RAD corpus (K1 4 and K4 4 a step; finite
    losses, BatchNorm statistics moved), one step against the CPU; one eval
    forward against the CPU."""
    import itertools

    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.synthetic import generate_synthetic_dataset
    from btia_tpu_torch.data.vocab import AnswerVocab, WordVocab
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.trainer import Trainer, batch_to_device, chunk_to_device

    cfg = get_config("vqa_rad_lstm")
    model = build_model(cfg.model, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 6: vqa_rad_lstm ({n_params / 1e6:.1f} M params), bf16")
    out = {"serve_step": _serve_phase(torch, dev, smi, model, cfg, cfg.model.question_vocab_size, _lstm_qids,
                                      counters, LSTM_SERVE_COUNTS, "vqa_rad_lstm", timed=True)}
    log(json.dumps({"vqa_rad_lstm_serve_step": {**out["serve_step"], "card": smi}}))
    corpus = ["is the lung normal", "is there a fracture", "is the heart enlarged", "is this an mri",
              "does the chest show pleural effusion", "is the lesion on the left", "is there a mass",
              "is the liver normal"]
    pred = Predictor(model, None, WordVocab.build(corpus), AnswerVocab(["yes", "no"]), cfg, device=dev)
    rng = np.random.RandomState(12)
    _zero(counters)
    for n in (1, 3, 8):
        img = rng.randint(0, 256, (300, 260, 3)).astype(np.uint8)
        got = pred.predict_answers(img, corpus[:n])
        if len(got) != n or not all(a in ("yes", "no") for a in got):
            raise AssertionError(f"vqa_rad_lstm Predictor returned {got}")
    counts = _counts(counters)
    log(f"  Predictor: three requests of 1, 3 and 8 questions launched {counts}")
    if counts != [3 * c for c in LSTM_PREDICT_COUNTS]:
        raise AssertionError(f"vqa_rad_lstm Predictor buckets launched {counts}, not 3 x {LSTM_PREDICT_COUNTS}")
    out["predictor_launches"] = counts
    del pred, model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rad_") as tmp:
        root = Path(tmp) / "vqa_rad"
        generate_synthetic_dataset(root, num_images=100)  # ~130 closed training pairs
        tcfg = get_config("vqa_rad_lstm", **{"data.data_dir": str(root), "train.warmup_steps": 2})
        trainer = Trainer(tcfg, Path(tmp) / "run", device=dev)
        K = tcfg.train.steps_per_call
        batches = list(itertools.islice(itertools.cycle(list(trainer.data.iterator("train", seed=0))), K))
        chunk = chunk_to_device(batches, dev)
        bn_before = trainer.model.image_encoder.stem_bn.mean.clone()
        torch.cuda.synchronize()
        _zero(counters)
        t0 = time.perf_counter()
        with plain_formula_calls() as plain:
            _, ms = trainer.train_step_scan(trainer.state, chunk)
            torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        counts = _counts(counters)
        losses = [float(x) for x in ms["loss"]]
        moved = (trainer.model.image_encoder.stem_bn.mean - bn_before).abs().max().item()
        expected = [K * c for c in LSTM_TRAIN_STEP_COUNTS]
        log(f"  one Trainer call of {K} scanned steps at batch {chunk['images'].shape[1]} in {call_s:.2f} s: "
            f"losses {losses}, stem BatchNorm mean moved {moved:.4g}; launched {counts}; the plain LayerNorm "
            f"formula on a CUDA tensor {plain[0]} times")
        if counts != expected or not np.all(np.isfinite(losses)) or not moved > 0 or plain[0]:
            raise AssertionError(f"vqa_rad_lstm train call: counts {counts} != {expected}, losses {losses}, "
                                 f"BN moved {moved}, the plain LayerNorm formula on the card {plain[0]} times")
        # Calls on K7's LayerNorms (forward and backward kernels) and on the
        # plain formula (the road before K7), in two rounds of turns.
        ab = k7_vs_plain_ms(torch, lambda: trainer.train_step_scan(trainer.state, chunk), 1, rounds=2)
        if "--profile" in sys.argv[1:]:
            profile_step(torch, lambda: trainer.train_step_scan(trainer.state, chunk), smi,
                         f"vqa_rad_lstm_trainer_call_of_{K}_steps")
        out["train_call"] = {"steps": K, "batch": int(chunk["images"].shape[1]), "seconds": call_s,
                             "ms_per_step": 1e3 * call_s / K, "losses": losses, "bn_stem_mean_moved": moved,
                             "launches": dict(zip(KERNELS + NEW_KERNELS, counts)),
                             "k7_vs_plain_layernorms_ms_per_step": [ab["k7"] / K, ab["plain"] / K],
                             "k7_vs_plain_turns_ms_per_call": ab["turns"],
                             "before_k7_ms_per_step": BEFORE_K7_MS["vqa_rad_lstm_train_step"]}
        out["eval"] = _eval_vs_cpu(torch, dev, trainer.model, batch_to_device(batches[0], dev), counters,
                                   LSTM_SERVE_COUNTS, "vqa_rad_lstm")
        del trainer, chunk
    torch.cuda.empty_cache()

    def batch(c):
        rng = np.random.RandomState(13)
        images = torch.from_numpy(rng.randint(0, 256, (B_TRAIN, 256, 256, 3)).astype(np.uint8))
        qids = torch.from_numpy(_lstm_qids(rng, (B_TRAIN,), c.model.question_vocab_size))
        return images, qids, torch.from_numpy(rng.randint(1, c.model.answer_vocab_size, B_TRAIN))

    out["train_step_vs_cpu"] = train_step_card_vs_cpu(torch, dev, "vqa_rad_lstm", batch, counters,
                                                      LSTM_TRAIN_STEP_COUNTS)
    log(json.dumps({"vqa_rad_lstm": {**out, "card": smi}}))
    return out


def slake_bert_phase(torch, dev, smi, counters):
    """Phase 6b: full-width slake_bert (ResNet-50, BERT-base, 2 BTIA layers
    at 12 heads of 64, mlp head), bf16, not timed: one serve step (K1 at the
    12 BERT and 4 BTIA sites), one train step through Trainer on a synthetic
    SLAKE corpus (K1 16, K4 16) and one eval forward, each against the CPU."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.synthetic import generate_synthetic_slake
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.trainer import Trainer, batch_to_device

    cfg = get_config("slake_bert")
    model = build_model(cfg.model, device=dev, seed=0)
    log(f"phase 6b: slake_bert ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params), bf16")
    out = {"serve_step": _serve_phase(torch, dev, smi, model, cfg, cfg.model.bert_vocab_size, _bert_qids,
                                      counters, SLAKE_SERVE_COUNTS, "slake_bert", timed=False)}
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slake_") as tmp:
        root = generate_synthetic_slake(Path(tmp) / "slake", num_images=64)  # 128 English pairs a split
        tcfg = get_config("slake_bert", **{"data.data_dir": str(root), "train.warmup_steps": 2})
        trainer = Trainer(tcfg, Path(tmp) / "run", device=dev)
        batch = batch_to_device(next(iter(trainer.data.iterator("train", seed=0))), dev)
        torch.cuda.synchronize()
        _zero(counters)
        _, m = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        counts = _counts(counters)
        loss = float(m["loss"])
        log(f"  one train step at batch {batch['images'].shape[0]}: loss {loss:.5f}; launched {counts}")
        if counts != SLAKE_TRAIN_COUNTS or not np.isfinite(loss):
            raise AssertionError(f"slake_bert train step: loss {loss}, counts {counts} != {SLAKE_TRAIN_COUNTS}")
        out["train_step"] = {"loss": loss, "launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
        out["eval"] = _eval_vs_cpu(torch, dev, trainer.model, batch, counters, SLAKE_SERVE_COUNTS, "slake_bert")
        del trainer, batch
    torch.cuda.empty_cache()

    def batch_fn(c):
        rng = np.random.RandomState(14)
        images = torch.from_numpy(rng.randint(0, 256, (B_TRAIN, 256, 256, 3)).astype(np.uint8))
        qids = np.zeros((B_TRAIN, SEQ), np.int64)
        for i in range(B_TRAIN):
            n = rng.randint(3, 16)
            qids[i, :n] = rng.randint(1, c.model.bert_vocab_size, n)
        return images, torch.from_numpy(qids), torch.from_numpy(rng.randint(1, c.model.answer_vocab_size, B_TRAIN))

    out["train_step_vs_cpu"] = train_step_card_vs_cpu(torch, dev, "slake_bert", batch_fn, counters,
                                                      SLAKE_TRAIN_COUNTS)
    log(json.dumps({"slake_bert": {**out, "card": smi}}))
    return out


def _host_ms(torch, fn, calls=3):
    """ms a call of fn under inference_mode, on the host's clock, each call
    ending in a synchronize (after one warm call)."""
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def fp32_phase(torch, dev, smi, counters):
    """Phase 6c: the fp32 policy on the card against the CPU (both f32,
    TF32 off: the two sum in other orders only, so logits within 1e-3 of
    the largest): vqa_rad_lstm's eval forward at batch 64 (K1 on the f32
    GEMM and the CUDA-core attention at its 4 BTIA sites); streaming_vitl's
    serve step of 2 images x 32 questions (K1, K2 and K3 on the f32 route);
    tiny_test (no gate passes: no kernel), one train step (loss and gradient
    norm within 1e-4 relative) and a Predictor answer. The first two are
    also timed (host clock over three calls, each ending in a synchronize,
    after the counted one)."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.vocab import AnswerVocab, WordVocab
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.steps import create_state, make_train_step

    out = {}
    rng = np.random.RandomState(15)
    log("phase 6c: the fp32 policy on the card against the CPU")

    cfg = get_config("vqa_rad_lstm", **{"model.mixed_precision": False})
    model = build_model(cfg.model, device=dev, seed=2)
    images = torch.from_numpy(rng.randint(0, 256, (B_TRAIN, 256, 256, 3)).astype(np.uint8))
    qids = torch.from_numpy(_lstm_qids(rng, (B_TRAIN,), cfg.model.question_vocab_size))
    torch.cuda.synchronize()
    _zero(counters)
    with torch.inference_mode():
        model(images.to(dev), qids.to(dev))
    torch.cuda.synchronize()
    counts = _counts(counters)
    err, scale = _card_vs_cpu(torch, model, lambda m, d: m(images.to(d), qids.to(d)),
                              "vqa_rad_lstm fp32 eval forward, batch 64", 1e-3)
    out["vqa_rad_lstm"] = {"launches": dict(zip(KERNELS + NEW_KERNELS, counts)),
                           "card_vs_cpu_max_abs_err": err, "card_vs_cpu_max_logit": scale,
                           "ms_per_forward": _host_ms(torch, lambda: model(images.to(dev), qids.to(dev)))}
    if counts != F32_LSTM_COUNTS:
        raise AssertionError(f"vqa_rad_lstm fp32 launch counts {counts} != {F32_LSTM_COUNTS}")
    del model
    torch.cuda.empty_cache()

    cfg = get_config("streaming_vitl", **{"model.mixed_precision": False})
    model = build_model(cfg.model, device=dev, seed=0)
    size = max(256, cfg.model.image_size)
    imgs = torch.from_numpy(rng.randint(0, 256, (2, size, size, 3)).astype(np.uint8))
    ids = torch.from_numpy(_bert_qids(rng, (2, 32), cfg.model.bert_vocab_size))
    fwd = lambda m, d: m.answer_questions(m.encode_image(imgs.to(d)), ids.to(d))
    torch.cuda.synchronize()
    _zero(counters)
    with torch.inference_mode():
        fwd(model, dev)
    torch.cuda.synchronize()
    counts = _counts(counters)
    err, scale = _card_vs_cpu(torch, model, fwd, "streaming_vitl fp32 serve step, 2 images x 32 questions", 1e-3)
    out["streaming_vitl"] = {"launches": dict(zip(KERNELS + NEW_KERNELS, counts)),
                             "card_vs_cpu_max_abs_err": err, "card_vs_cpu_max_logit": scale,
                             "ms_per_step": _host_ms(torch, lambda: fwd(model, dev))}
    if counts != F32_VITL_COUNTS:
        raise AssertionError(f"streaming_vitl fp32 launch counts {counts} != {F32_VITL_COUNTS}")
    del model
    torch.cuda.empty_cache()

    cfg = get_config("tiny_test", **{"model.dropout": 0.0})
    model = build_model(cfg.model, device=dev, seed=0)
    cpu_model = copy.deepcopy(model).to("cpu")
    B = cfg.train.batch_size
    batch = {"images": torch.from_numpy(rng.randint(0, 256, (B, 256, 256, 3)).astype(np.uint8)),
             "question_ids": torch.from_numpy(_lstm_qids(rng, (B,), cfg.model.question_vocab_size)[:, :12]),
             "answer_ids": torch.from_numpy(rng.randint(1, cfg.model.answer_vocab_size, B))}
    _zero(counters)
    metrics = {}
    for m, d in ((model, dev), (cpu_model, "cpu")):
        state = create_state(m, cfg, steps_per_epoch=10)
        _, met = make_train_step(m, cfg)(state, {k: v.to(d) for k, v in batch.items()})
        metrics[str(d)] = {k: float(v) for k, v in met.items()}
    counts = _counts(counters)
    mg, mc = metrics[str(dev)], metrics["cpu"]
    log(f"  tiny_test train step: card {mg}, CPU {mc}; launched {counts}")
    if not all(abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]) for k in ("loss", "grad_norm")):
        raise AssertionError(f"tiny_test train step: card {mg} and CPU {mc} disagree")
    corpus = ["is the lung normal", "what organ is shown", "is there a fracture"]
    answers = AnswerVocab([f"answer {i}" for i in range(20)])
    img = rng.randint(0, 256, (200, 240, 3)).astype(np.uint8)
    got = {}
    for m, d in ((model, dev), (cpu_model, "cpu")):
        p = Predictor(m, None, WordVocab.build(corpus), answers, cfg, device=d)
        got[str(d)] = (p.predict_batch(img, corpus), p.predict_answers(img, corpus))
    counts = _counts(counters)
    err = float(np.abs(got[str(dev)][0] - got["cpu"][0]).max())
    scale = float(np.abs(got["cpu"][0]).max())
    log(f"  tiny_test Predictor: {got[str(dev)][1]}; card vs CPU logits {err:.4g} at {scale:.4g}; launched {counts}")
    if not err <= 1e-3 * scale or got[str(dev)][1] != got["cpu"][1] or counts != F32_TINY_COUNTS:
        raise AssertionError(f"tiny_test Predictor: err {err} > {1e-3 * scale}, answers {got}, counts {counts}")
    out["tiny_test"] = {"train_step_card": mg, "train_step_cpu": mc, "predictor_max_abs_err": err,
                        "predictor_max_logit": scale, "launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
    del model, cpu_model
    torch.cuda.empty_cache()
    log(json.dumps({"fp32_policy": {**out, "card": smi}}))
    return out


def _cli(argv):
    """``btia_tpu_torch.cli.main(argv)`` in this process (so that the launch
    counters can be read), its stdout and stderr captured and returned; a
    non-zero exit fails the phase. SIGTERM and SIGINT handlers that `train`
    installs are put back."""
    import io
    import signal

    from btia_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli_main([str(a) for a in argv])
    except SystemExit as e:
        if e.code not in (None, 0):
            raise AssertionError(f"cli {argv[0]} exited with {e.code}: {err.getvalue()[-2000:]}") from e
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    return out.getvalue(), err.getvalue()


def cli_phase(torch, dev, smi, counters, overrides=()):
    """Phase 7a: ``python -m btia_tpu_torch.cli`` train -> eval -> predict ->
    serve on full-width vqa_rad_lstm over a synthetic VQA-RAD corpus, in
    this process, every counter set to 0 just before each command and read
    just after: train K1 4 a train step and an eval batch, K4 4 a train
    step, K7 14 a train step and 6 a val batch; eval K1 4 and K7 6 a batch;
    predict (under the batch floor) K7 14 only; serve K1 4 and K7 6 a batch
    (warmup included), K4 0."""
    import numpy as np

    from btia_tpu_torch.cli import _parse_overrides
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.builder import build_data
    from btia_tpu_torch.data.synthetic import generate_synthetic_dataset

    out = {}
    dv = ["--device", dev.type]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        root, work = Path(tmp) / "vqa_rad", Path(tmp) / "run"
        generate_synthetic_dataset(root, num_images=160)
        sets = [f"data.data_dir={root}", "train.epochs=1", *overrides]
        data = build_data(get_config("vqa_rad_lstm", **_parse_overrides(sets)))
        steps, val_b, test_b = data.steps("train"), data.steps("val"), data.steps("test")
        if steps < 2:
            raise AssertionError(f"the CLI corpus fills {steps} train step(s) of vqa_rad_lstm, not 2")
        # K7 as phase 6's: 14 a train step, 6 a val or test batch, 14 for
        # the predict request (under the batch floor); its backward kernel
        # 14 a train step.
        expect = {
            "train": [4 * (steps + val_b), 0, 0, 4 * steps, 0, 0, 14 * steps + 6 * val_b, 0, 14 * steps] + [0] * 3,
            "eval": [4 * test_b] + [0] * 5 + [6 * test_b] + [0] * 5, "predict": LSTM_PREDICT_COUNTS,
        }
        cmds = {
            "train": ["train", "--config", "vqa_rad_lstm", "--workdir", work,
                      *[a for s in sets for a in ("--set", s)]],
            "eval": ["eval", "--workdir", work, "--split", "test"],
            "predict": ["predict", "--workdir", work, "--image", root / "images" / "synpic0.dcm",
                        "--question", "is the lung normal", "--question", "is there a fracture"],
        }
        for name, argv in cmds.items():
            torch.cuda.synchronize()
            _zero(counters)
            t0 = time.perf_counter()
            stdout, _ = _cli([*argv, *dv])
            torch.cuda.synchronize()
            counts = _counts(counters)
            out[name] = {"seconds": time.perf_counter() - t0, "launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
            log(f"phase 7a: cli {name} on vqa_rad_lstm in {out[name]['seconds']:.1f} s launched {counts}; "
                f"stdout {' '.join(stdout.split())[:400]}")
            if counts != expect[name]:
                raise AssertionError(f"cli {name} launch counts {counts} != {expect[name]}")
            if name == "train":
                row = json.loads(stdout)
                if not (np.isfinite(row["train_loss"]) and 0.0 <= row["val_accuracy"] <= 1.0):
                    raise AssertionError(f"cli train: bad epoch row {row}")
                out[name].update(steps=steps, row=row)
            elif name == "eval":
                metrics = json.loads(stdout)
                if not 0.0 <= metrics["accuracy"] <= 1.0:
                    raise AssertionError(f"cli eval: bad metrics {metrics}")
                out[name]["metrics"] = metrics
            else:
                rows = [json.loads(ln) for ln in stdout.strip().splitlines()]
                top = min(3, len(data.answer_vocab) - 1)  # real answers: the vocabulary less <unk>
                if len(rows) != 2 or not all(len(r["top"]) == top and all(np.isfinite(a["logit"]) for a in r["top"])
                                             for r in rows):
                    raise AssertionError(f"cli predict: bad rows {rows}")
                out[name]["rows"] = rows
        images = [p for p in (root / "images").iterdir() if p.suffix.lower() in (".jpg", ".dcm", ".png")]
        batches = 1 + math.ceil(len(images) / CLI_SERVE_BATCH)
        expect = [4 * batches] + [0] * 5 + [6 * batches] + [0] * 5
        torch.cuda.synchronize()
        _zero(counters)
        t0 = time.perf_counter()
        stdout, stderr = _cli(["serve", "--workdir", work, "--image-dir", root / "images", "--batch", CLI_SERVE_BATCH,
                               "--topk", 3, "--dedup", *[a for q in CLI_QUESTIONS for a in ("--question", q)], *dv])
        torch.cuda.synchronize()
        counts = _counts(counters)
        rows = [json.loads(ln) for ln in stdout.strip().splitlines()]
        summary = json.loads(stderr.strip().splitlines()[-1])
        out["serve"] = {"seconds": time.perf_counter() - t0, "images": len(images), "batches": batches,
                        "launches": dict(zip(KERNELS + NEW_KERNELS, counts)), "summary": summary}
        log(f"phase 7a: cli serve of {len(images)} images x {len(CLI_QUESTIONS)} questions (top-3, dedup, batch "
            f"{CLI_SERVE_BATCH}) launched {counts}; {summary}")
        if counts != expect:
            raise AssertionError(f"cli serve launch counts {counts} != {expect}")
        if (sorted(r["image"] for r in rows) != sorted(p.name for p in images)
                or not all(len(r["answers"]) == len(CLI_QUESTIONS) for r in rows)
                or summary["pairs"] != len(images) * len(CLI_QUESTIONS)):
            raise AssertionError(f"cli serve: {len(rows)} rows for {len(images)} images, summary {summary}")
    log(json.dumps({"cli": {**out, "card": smi}}))
    return out


def _reference_state_dict(torch, model):
    """A reference-PyTorch state_dict of `model`: the converter's key rule
    (``convert/convert.py::_torch_key``) run backwards, Dense kernels
    transposed to torch's (out, in), BatchNorm's ``num_batches_tracked``
    added as torch writes it."""
    from btia_tpu_torch.convert.convert import _torch_key

    sd = {}
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        key, kind = _torch_key(tuple(name.split(".")))
        sd[key] = (t.T if kind == "kernel" and t.ndim == 2 else t).detach().cpu().contiguous().clone()
        if name.endswith(".mean"):
            sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return sd


def convert_phase(torch, dev, smi, counters, overrides=()):
    """Phase 7b: a reference-layout checkpoint of a seeded vqa_rad_lstm
    through ``cli convert`` on the card; ``Predictor.from_checkpoint`` of the
    workdir against the seeded model, 64 questions on one image (K1 fused),
    logits bitwise equal."""
    import numpy as np

    from btia_tpu_torch.cli import _parse_overrides
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.vocab import AnswerVocab, WordVocab
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.models.model import build_model

    cfg = get_config("vqa_rad_lstm", **_parse_overrides(overrides))
    model = build_model(cfg.model, device=dev, seed=21)
    questions = [f"{q} {i}" for i in range(4) for q in CLI_QUESTIONS]  # 64
    vocab, answers = WordVocab.build(questions), AnswerVocab(["yes", "no"])
    img = np.random.RandomState(13).randint(0, 256, (300, 260, 3)).astype(np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as tmp:
        ckpt, work = Path(tmp) / "ref.pt", Path(tmp) / "converted"
        torch.save({"state_dict": _reference_state_dict(torch, model)}, ckpt)
        t0 = time.perf_counter()
        stdout, _ = _cli(["convert", "--config", "vqa_rad_lstm", "--torch-ckpt", ckpt, "--workdir", work,
                          *[a for s in overrides for a in ("--set", s)], "--device", dev.type])
        convert_s = time.perf_counter() - t0
        (work / "vocabs").mkdir()
        vocab.save(work / "vocabs" / "question_vocab.json")
        answers.save(work / "vocabs" / "answer_vocab.json")
        loaded = Predictor.from_checkpoint(work, device=dev)
        _zero(counters)
        got = loaded.predict_batch(img, questions)
        counts = _counts(counters)
        want = Predictor(model, None, vocab, answers, cfg, device=dev).predict_batch(img, questions)
    err = float(np.abs(got - want).max())
    res = {"convert_s": convert_s, "max_abs_diff": err, "bitwise": bool(np.array_equal(got, want)),
           "max_logit": float(np.abs(want).max()), "launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
    log(f"phase 7b: {stdout.strip()}; from_checkpoint vs the seeded model: {json.dumps(res)}")
    if not res["bitwise"] or counts[0] != 4:
        raise AssertionError(f"converted checkpoint: logits differ by {err} (bitwise expected), counts {counts}")
    del model, loaded
    torch.cuda.empty_cache()
    return res


def bench_phase(torch, dev, smi, counters, serve_ms, lstm_serve_ms):
    """Phase 7c: ``python -m btia_tpu_torch.cli bench`` as a user runs it (a
    subprocess, full defaults, streaming_vitl): its JSON line; then the
    bench's ``run`` in this process at the same shape on streaming_vitl and
    vqa_rad_lstm, every counter set to 0 just before and read just after:
    per step phase 4's and phase 6's counts."""
    from btia_tpu_torch import bench

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "btia_tpu_torch.cli", "bench"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"cli bench exited with {res.returncode}: {res.stderr[-3000:]}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    detail = json.loads([ln for ln in res.stderr.strip().splitlines() if ln.startswith("{")][-1])
    if (line["metric"] != "image_question_pairs_per_sec_per_chip" or line["unit"] != "pairs/s/chip"
            or not line["value"] > 0 or line["vs_baseline"] != round(line["value"] / 5000.0, 3)):
        raise AssertionError(f"cli bench printed {line}")
    out = {"cli_bench": {"stdout": line, "detail": detail, "seconds": time.perf_counter() - t0}}
    log(f"phase 7c: python -m btia_tpu_torch.cli bench: {json.dumps(line)}; {json.dumps(detail)}")
    for config, phase_ms in (("streaming_vitl", serve_ms), ("vqa_rad_lstm", lstm_serve_ms)):
        torch.cuda.synchronize()
        _zero(counters)
        r = bench.run(config, device=dev)
        torch.cuda.synchronize()
        counts = _counts(counters)
        n = r["detail"]["steps_run"]
        expect = [c * n for c in BENCH_STEP_COUNTS[config]]
        out[config] = {**r, "launches": dict(zip(KERNELS + NEW_KERNELS, counts)), "phase_serve_ms": phase_ms}
        log(f"  bench.run({config!r}) in process: {json.dumps(r['result'])}; step_ms {r['detail']['step_ms']} "
            f"(the serve step of phase {'4' if config == 'streaming_vitl' else '6'}: {phase_ms:.2f} ms); "
            f"{n} steps launched {counts}")
        if counts != expect:
            raise AssertionError(f"bench {config} launch counts {counts} != {expect} ({n} steps)")
        torch.cuda.empty_cache()
    log(json.dumps({"bench": {**out, "card": smi}}))
    return out


def remat_phase(torch, dev, smi, counters):
    """Phase 7d: one vqa_med_full train step (forward and backward) at batch
    64 with dropout 0.1, without and with ``model.remat``, same weights, same
    batch and the same step generator: the losses equal, the gradients
    within 1e-6 of the largest or within the spread of the plain step run
    twice (atomics in a backward sum in any order); the peak memory of each
    (reported), the launches of each (the recompute's K1 and K3 in the
    backward pass: REMAT_COUNTS), and the step times, taken in turns."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.steps import cross_entropy, dropout_generator

    cfg = get_config("vqa_med_full")
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randint(0, 256, (B_TRAIN, 256, 256, 3)).astype(np.uint8)).to(dev)
    qids = np.zeros((B_TRAIN, cfg.model.max_question_len), np.int64)
    for i in range(B_TRAIN):
        n = rng.randint(3, 16)
        qids[i, :n] = rng.randint(1, cfg.model.bert_vocab_size, n)
    qids = torch.from_numpy(qids).to(dev)
    labels = torch.from_numpy(rng.randint(1, cfg.model.answer_vocab_size, B_TRAIN)).to(dev)
    plain = build_model(cfg.model, device=dev, seed=1)
    remat = build_model(get_config("vqa_med_full", **{"model.remat": True}).model, device=dev, seed=1)
    remat.load_state_dict(plain.state_dict())

    def step(m):
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        t0 = time.perf_counter()
        logits = m(images, qids, train=True, generator=dropout_generator(0, 7, dev))
        loss = cross_entropy(logits, labels)
        loss.backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        return {"loss": loss.item(), "grads": grads, "ms": ms, "counts": _counts(counters),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    step(plain)  # warm: the allocator's first blocks
    step(remat)
    a, b, r = step(plain), step(plain), step(remat)
    big = float(a["grads"].abs().max())
    diff = float((r["grads"] - a["grads"]).abs().max())
    noise = float((b["grads"] - a["grads"]).abs().max())
    # Step times in turns (plain, remat, remat, plain, twice): medians.
    ms = {plain: [], remat: []}
    for m in (plain, remat, remat, plain) * 2:
        ms[m].append(step(m)["ms"])
    res = {"loss": a["loss"], "loss_remat": r["loss"], "max_grad": big, "grad_max_abs_diff": diff,
           "plain_rerun_max_abs_diff": noise, "ms": float(np.median(ms[plain])),
           "ms_remat": float(np.median(ms[remat])), "ms_each": [ms[plain], ms[remat]],
           "peak_gib": a["peak_gib"], "peak_gib_remat": r["peak_gib"],
           "launches": dict(zip(KERNELS + NEW_KERNELS, a["counts"])),
           "launches_remat": dict(zip(KERNELS + NEW_KERNELS, r["counts"]))}
    log(f"phase 7d: vqa_med_full train step at batch {B_TRAIN}, dropout 0.1, without / with model.remat: "
        f"{json.dumps(res)}")
    del plain, remat, a, b, r
    torch.cuda.empty_cache()
    if res["loss"] != res["loss_remat"] or diff > max(1e-6 * big, noise):
        raise AssertionError(f"remat step differs from the plain step: {res}")
    if res["launches"] != dict(zip(KERNELS + NEW_KERNELS, TRAIN_COUNTS + [0, 0, 0])) or \
            list(res["launches_remat"].values()) != REMAT_COUNTS:
        raise AssertionError(f"remat step launch counts: {res}")
    return res


def profiling_phase(torch, dev, smi, counters):
    """Phase 7e: the profiling hooks on the card, around the bench's serve
    step of full-width vqa_rad_lstm (16 x 128, K1 4 a step): ``Timer.span``
    on CUDA events, each span's result a list the block fills, against the
    host clock around the same steps; ``fetch``'s host copies; the card's
    ``memory_stats``; ``trace``'s Chrome trace, which must hold the card's
    kernels (device time in ``key_averages``)."""
    import numpy as np

    from btia_tpu_torch import bench
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.utils.profiling import Timer, fetch, memory_stats, trace

    cfg = get_config("vqa_rad_lstm")
    model = build_model(cfg.model, device=dev, seed=0)
    rng = np.random.RandomState(17)
    images = torch.from_numpy(rng.randint(0, 256, (B_IMG, 256, 256, 3)).astype(np.uint8)).to(dev)
    qids = torch.from_numpy(_lstm_qids(rng, (B_IMG, N_Q), cfg.model.question_vocab_size)).to(dev)
    step = lambda: bench.serve_step(model, images, qids, 5)
    fetch(step())
    timer = Timer()
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        out = []
        with timer.span(result=out):
            out.extend(step())
    host_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    counts = _counts(counters)
    host = fetch({"topk": step()})
    stats = memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with trace(Path(tmp) / "trace") as prof:
            fetch(step())
        files = list((Path(tmp) / "trace").glob("*.json"))
        trace_mb = sum(f.stat().st_size for f in files) / 1e6
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    res = {"timer_mean_ms": timer.mean_ms, "spans": timer.count, "host_ms": host_ms,
           "fetched": [list(t.shape) for t in host["topk"]], "fetched_device": str(host["topk"][0].device),
           "allocated_gib": stats.get("allocated_bytes.all.current", 0) / 2**30, "trace_files": len(files),
           "trace_mb": trace_mb, "trace_device_ms": device_us / 1e3,
           "launches": dict(zip(KERNELS + NEW_KERNELS, counts))}
    log(f"phase 7e: profiling hooks around the vqa_rad_lstm serve step: {json.dumps(res)}")
    del model
    torch.cuda.empty_cache()
    if (timer.count != TIMED_STEPS or not 0 < timer.mean_ms <= 1.5 * host_ms or counts[0] != 4 * TIMED_STEPS
            or res["fetched"] != [[B_IMG, N_Q, 5]] * 2 or res["fetched_device"] != "cpu"
            or not res["allocated_gib"] > 0 or len(files) != 1 or not device_us > 0):
        raise AssertionError(f"profiling hooks on the card: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase 8: the mesh — two gloo ranks on the one card.

P8_IMAGES, P8_QUESTIONS = 4, 64  # 256 question rows a rank: every K1/K2 site at or above the batch floor
P8_TIMED = 3
P8_RANK_TIMEOUT_S = 420
P8_GLOO_TIMEOUT_S = 180
P8_BACKEND = "gloo"
P8_CAVEAT = ("two ranks time-share one H100 and all-reduce through the host (gloo): not a multi-GPU "
             "figure")
# Per rank of streaming_vitl's (1, 2) mesh at 4 x 64: BERT's 12 and BTIA's
# 8 K1 sites, the AD head's K2 and ViT-L's 24 blocks on K3 (8 of 16 heads);
# K7 the serve step's 74 and BERT's 12 post-LNs, which act on the model
# group's sum, outside K1's chain.
P8_SERVE_COUNTS = [20, 1, 24, 0, 0, 0, 86, 0, 0, 0, 0, 0]
# ... and with int8 FFNs: K8 on each of the 45 Mlps' two products a rank.
P8_INT8_COUNTS = [20, 1, 24, 0, 0, 0, 86, 90, 0, 0, 0, 0]
# Per rank of the (2, 1) vqa_rad_lstm step at 64 rows: 4 K1 sites, K4 in
# the backward of each; K7 and its backward kernel as phase 6's train step.
P8_TRAIN_COUNTS = [4, 0, 0, 4, 0, 0, 14, 0, 14, 0, 0, 0]
P8_BATCH = 128
# 8c's bounds, DP step against the one-process step, phase 6's for the card
# against the CPU on batch statistics (``_step_check``): bf16 on the loss,
# the norm and the BatchNorm statistics (its gradients, rounding-dominated
# through a random-init ResNet, are reported); fp32 on every gradient too.
# Every parameter within 2.5 learning rates: the first Adam step moves an
# element by at most one, so a gradient whose sign rounding flips by two.
P8_TRAIN_BOUNDS = {
    "bf16": {"loss_rel": 0.01, "grad_norm_rel": 0.02, "bn_stats_rel_l2": 0.05, "param_max_abs_diff_over_lr": 2.5},
    "fp32": {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "grad_rel_l2_rest": 1e-3, "grad_rel_l2_encoder": 0.05,
             "bn_stats_rel_l2": 1e-4, "param_max_abs_diff_over_lr": 2.5},
}


def p8_reckoned_bytes(cfg, B, Q):
    """The all-reduced bytes of one (1, 2) serve step as reckoned by hand:
    each row-parallel product sums its rows x Dout bf16 partials once. With
    ``model.int8_ffn`` each fc2 instead takes the maximum of its rows' f32
    amaxes and sums its rows x Dout int32 partials (K8's row-parallel road);
    its weight's column amaxes are all-reduced when the weight is prepared,
    in the first step only."""
    from btia_tpu_torch.models.vit import VIT_SPECS

    m = cfg.model
    vit = VIT_SPECS[m.image_encoder]
    txt, img, head = B * Q * m.max_question_len, B * Q * (m.image_pool_grid ** 2 + 1), B * Q * m.num_answer_queries
    # (rows, Dout) of the o_proj and of the fc2 of each block: ViT's, BERT's,
    # BTIA's (i2t / t2i o_proj, both Mlps) and the AD head's.
    sites = ([(vit.depth * B * vit.num_tokens, vit.dim), (m.bert_layers * txt, m.bert_hidden),
              (m.btia_layers * (img + txt), m.hidden_dim), (head, m.hidden_dim)])
    o_proj = sum(2 * rows * dout for rows, dout in sites)
    if not m.int8_ffn:
        return 2 * o_proj
    return o_proj + sum(4 * rows * dout + 4 * rows for rows, dout in sites)


def _p8_rank_serve(torch, dev, mesh, tmp):
    """8a / 8b on one rank: full-width streaming_vitl under its registered
    mesh through make_sharded_serve_fn, then Predictor(mesh=)."""
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.infer.sharded import make_sharded_serve_fn, shard_serving_params
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.parallel import collectives as C

    counters = launch_counters() + new_counters()
    inp = torch.load(tmp / "p8_serve_inputs.pt", weights_only=False)
    cfg = get_config("streaming_vitl")
    model = build_model(cfg.model, device=dev, seed=0)
    shard_serving_params(model, mesh)
    torch.cuda.empty_cache()
    serve = make_sharded_serve_fn(model, mesh)
    imgs, qids = torch.from_numpy(inp["images"]).to(dev), torch.from_numpy(inp["qids"]).to(dev)
    serve(imgs, qids)  # the first step prepares K1/K2's weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    C.reset_stats()
    logits = serve(imgs, qids)
    torch.cuda.synchronize()
    out = {"counts": _counts(counters), "reduced": {a: dict(s) for a, s in C.stats.items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "logits": logits.float().cpu()}
    t0 = time.perf_counter()
    for _ in range(P8_TIMED):
        serve(imgs, qids)
    torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / P8_TIMED
    out["param_gib"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    # 8b: the same (sharded) model behind Predictor(mesh=).
    corpus = inp["corpus"]
    pred = Predictor(model, None, WordPieceTokenizer.toy_vocab(corpus), AnswerVocab(inp["answers"]), cfg,
                     device=dev, mesh=mesh)
    _zero(counters)
    out["predict_batch"] = pred.predict_batch(inp["image"], corpus)
    out["predict"] = pred.predict(inp["image"], corpus[0])
    out["predict_answers"] = pred.predict_answers(inp["image"], corpus)
    out["predict_counts"] = _counts(counters)
    # 8d: the same seeded weights with int8 FFNs under the same mesh.
    del pred, model, serve
    torch.cuda.empty_cache()
    cfg8 = get_config("streaming_vitl", **{"model.int8_ffn": True})
    model8 = build_model(cfg8.model, device=dev, seed=0)
    shard_serving_params(model8, mesh)
    serve8 = make_sharded_serve_fn(model8, mesh)
    serve8(imgs, qids)  # the first step prepares the weights (and all-reduces fc2's column amaxes)
    torch.cuda.synchronize()
    _zero(counters)
    C.reset_stats()
    logits8 = serve8(imgs, qids)
    torch.cuda.synchronize()
    out["int8"] = {"counts": _counts(counters), "reduced": {a: dict(s) for a, s in C.stats.items()},
                   "logits": logits8.float().cpu()}
    t0 = time.perf_counter()
    for _ in range(P8_TIMED):
        serve8(imgs, qids)
    torch.cuda.synchronize()
    out["int8"]["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / P8_TIMED
    return out


def _p8_train_batch(torch, cfg):
    import numpy as np

    rng = np.random.RandomState(13)
    return {"images": torch.from_numpy(rng.randint(0, 256, (P8_BATCH, 256, 256, 3)).astype(np.uint8)),
            "question_ids": torch.from_numpy(_lstm_qids(rng, (P8_BATCH,), cfg.model.question_vocab_size)),
            "answer_ids": torch.from_numpy(rng.randint(1, cfg.model.answer_vocab_size, P8_BATCH)),
            "valid": torch.ones(P8_BATCH, dtype=torch.bool)}


def p8_train_step(torch, dev, mesh=None, mixed=True):
    """One vqa_rad_lstm train step (bf16, or fp32 with `mixed` off; dropout
    0, no warmup: the step moves the weights) on the global batch of
    P8_BATCH, this rank's rows of it under a mesh. Returns the launch
    counts, the metrics, the gradients the optimizer applied (averaged over
    the data group), the parameters and BatchNorm statistics after the
    step, the step's time and peak memory, and the time of a second step
    (warm, not compared)."""
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.parallel.sharding import shard_batch
    from btia_tpu_torch.train.steps import create_state, make_train_step

    counters = launch_counters() + new_counters()
    cfg = get_config("vqa_rad_lstm", **{"model.dropout": 0.0, "train.warmup_steps": 0,
                                        "model.mixed_precision": mixed})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what the process held before: not the step's
    model = build_model(cfg.model, device=dev, seed=1)
    state = create_state(model, cfg, steps_per_epoch=10, mesh=mesh)
    step = make_train_step(model, cfg, mesh)
    batch = _p8_train_batch(torch, cfg)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}
    seen = {}
    adamw_step = state.optimizer.adamw.step

    def capture(*a, **k):
        if not seen:
            seen.update({n: p.grad.float().cpu() for n, p in zip(state.optimizer.names, state.optimizer.params)})
        return adamw_step(*a, **k)

    state.optimizer.adamw.step = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    _, m = step(state, batch)
    torch.cuda.synchronize()
    out = {"counts": _counts(counters), "seconds": time.perf_counter() - t0,
           "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
           "metrics": {k: float(v) for k, v in m.items()}, "grads": seen,
           "state": {k: v.float().cpu() for k, v in model.state_dict().items()},
           "lr": cfg.train.lr, "rows": int(batch["images"].shape[0])}
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    out["warm_seconds"] = time.perf_counter() - t0
    del model, state
    torch.cuda.empty_cache()
    return out


def p8_train_steps(torch, dev, mesh=None):
    return {"bf16": p8_train_step(torch, dev, mesh, True), "fp32": p8_train_step(torch, dev, mesh, False)}


# 8e: one tensor-parallel train step of streaming_vitl under its registered
# mesh (world 2 -> data 1, model 2) at its registered widths (ViT-L/336 at
# 1024 with 16 heads, BERT-base at 768 with 12, BTIA at 768 with 12, the AD
# head of 64 queries over 2048 answers), depth cut to P8E_DEPTH, bf16,
# dropout 0, no warmup, on a global batch of P8E_IMAGES images x
# P8E_QUESTIONS questions (64 pairs: every K1 / K2 site at the batch floor,
# so on its shard), against the one-process step on the same batch.
P8E_DEPTH = {"vit": 2, "bert": 2, "btia": 2}
P8E_IMAGES, P8E_QUESTIONS = 8, 8
# A rank's launches: K1 at BERT's 2 and BTIA's 4 sites, K2 at the AD head,
# K3 at the 2 ViT blocks (577 tokens: unfused), K4 in the backward of each
# K1 site and of K2 (its recompute's short attention at 64 rows); K7 the
# forward's 18 standalone LayerNorms (ViT 2 x 2 + 1, img_ln, BERT's embedding
# LN, 2 ln_mlp and 2 post-LNs on the model group's sum, txt_ln, BTIA's 4, the
# head's 2) and 9 in the backward (the recompute of the BTIA sites' q and kv
# LNs and of K2's kv LN). One process: the same 27, BERT's post-LNs in K1's
# chain and in its backward's recompute. K7's backward kernel once for each
# of the 27.
P8E_COUNTS = [6, 1, 2, 7, 0, 0, 27, 0, 27, 0, 0, 0]
# Bounds as 8c's bf16 ones (P8_TRAIN_BOUNDS): the loss, the global gradient
# norm (its squares summed over the model group), and every parameter after
# the step within 2.5 learning rates of the one-process one (the first Adam
# step moves an element by at most one; a gradient whose sign a bf16
# rounding flips, by two).
P8E_BOUNDS = {"loss_rel": 0.01, "grad_norm_rel": 0.02, "param_max_abs_diff_over_lr": 2.5}


@contextlib.contextmanager
def _vit_depth(depth):
    """ViT-L/336 built with `depth` blocks, its widths as registered."""
    import dataclasses

    from btia_tpu_torch.models.vit import VIT_SPECS

    spec = VIT_SPECS["vit_l336"]
    VIT_SPECS["vit_l336"] = dataclasses.replace(spec, depth=depth)
    try:
        yield
    finally:
        VIT_SPECS["vit_l336"] = spec


def p8e_config():
    from btia_tpu_torch.configs import get_config

    return get_config("streaming_vitl", **{"model.dropout": 0.0, "train.warmup_steps": 0,
                                           "model.bert_layers": P8E_DEPTH["bert"],
                                           "model.btia_layers": P8E_DEPTH["btia"]})


def _p8e_batch(torch, cfg):
    """P8E_IMAGES images, each paired with P8E_QUESTIONS questions."""
    import numpy as np

    rng = np.random.RandomState(14)
    n = P8E_IMAGES * P8E_QUESTIONS
    images = rng.randint(0, 256, (P8E_IMAGES, cfg.model.image_size, cfg.model.image_size, 3)).astype(np.uint8)
    return {"images": torch.from_numpy(np.repeat(images, P8E_QUESTIONS, axis=0)),
            "question_ids": torch.from_numpy(_lstm_qids(rng, (n,), cfg.model.bert_vocab_size)),
            "answer_ids": torch.from_numpy(rng.randint(1, cfg.model.answer_vocab_size, n)),
            "valid": torch.ones(n, dtype=torch.bool)}


def p8e_train_step(torch, dev, mesh=None):
    """One streaming_vitl train step of 8e (``p8e_config``, ViT depth cut to
    P8E_DEPTH) on this rank's shard under `mesh`, or in one process. Returns
    the launch counts, the metrics, the parameters after the step (gathered
    over the model group), the step's time and peak memory, and a second
    (warm) step's time."""
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.parallel.sharding import shard_batch
    from btia_tpu_torch.train.steps import create_state, make_train_step

    counters = launch_counters() + new_counters()
    cfg = p8e_config()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    with _vit_depth(P8E_DEPTH["vit"]):
        model = build_model(cfg.model, device=dev, seed=2)
    state = create_state(model, cfg, steps_per_epoch=10, mesh=mesh)
    step = make_train_step(model, cfg, mesh)
    batch = _p8e_batch(torch, cfg)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    _, m = step(state, batch)
    torch.cuda.synchronize()
    out = {"counts": _counts(counters), "seconds": time.perf_counter() - t0,
           "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
           "metrics": {k: float(v) for k, v in m.items()},
           "params": {k: v.float().cpu() for k, v in state.state_dict()["params"].items()},
           "local_param_gib": sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30,
           "lr": cfg.train.lr, "rows": int(batch["images"].shape[0])}
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    out["warm_seconds"] = time.perf_counter() - t0
    del model, state
    torch.cuda.empty_cache()
    return out


def tp_train_phase(torch, dev, smi, tmp):
    """8e: the tensor-parallel train step against the one-process step (see
    P8E_DEPTH ... P8E_BOUNDS)."""
    one = p8e_train_step(torch, dev)
    t0 = time.perf_counter()
    ranks = _p8_spawn(torch, "tp_train", tmp)
    res = {"config": "streaming_vitl", "depth": P8E_DEPTH, "pairs": P8E_IMAGES * P8E_QUESTIONS,
           "mesh": ranks[0]["mesh"], "ranks_wall_s": time.perf_counter() - t0,
           "one_process": {k: one[k] for k in ("seconds", "warm_seconds", "peak_gib", "metrics", "local_param_gib")},
           "ranks": [], "card": smi}
    res["one_process"]["counts"] = dict(zip(KERNELS + NEW_KERNELS, one["counts"]))
    w = one["metrics"]
    for r, o in enumerate(ranks):
        m = o["metrics"]
        row = {"rank": r, "rows": o["rows"], "counts": dict(zip(KERNELS + NEW_KERNELS, o["counts"])),
               "metrics": m, "seconds": o["seconds"], "warm_seconds": o["warm_seconds"], "peak_gib": o["peak_gib"],
               "local_param_gib": o["local_param_gib"],
               "loss_rel": abs(m["loss"] - w["loss"]) / abs(w["loss"]),
               "grad_norm_rel": abs(m["grad_norm"] - w["grad_norm"]) / w["grad_norm"],
               "param_max_abs_diff_over_lr": max((o["params"][n] - one["params"][n]).abs().max().item()
                                                 for n in one["params"]) / one["lr"],
               "same_parameter_names": sorted(o["params"]) == sorted(one["params"])}
        res["ranks"].append(row)
        log(f"  8e rank {r} ({o['rows']} rows): {json.dumps(row)}")
        bad = {k: row[k] for k, bound in P8E_BOUNDS.items() if not row[k] <= bound}
        if bad or not row["same_parameter_names"] or not all(map(math.isfinite, m.values())):
            raise AssertionError(f"phase 8e rank {r}: the TP step disagrees with the one-process step past "
                                 f"{P8E_BOUNDS}: {bad} (names equal: {row['same_parameter_names']}, metrics {m})")
        if o["counts"] != P8E_COUNTS or one["counts"] != P8E_COUNTS:
            raise AssertionError(f"phase 8e: launch counts {o['counts']} / one process {one['counts']} != "
                                 f"{P8E_COUNTS}")
    log(f"  8e one process: {one['seconds']:.3f} s (warm {one['warm_seconds']:.3f}), peak {one['peak_gib']:.2f} "
        f"GiB; ranks warm {[round(r['warm_seconds'], 3) for r in res['ranks']]} s, peak "
        f"{[round(r['peak_gib'], 2) for r in res['ranks']]} GiB ({P8_CAVEAT})")
    return res


def phase8_rank(argv) -> int:
    """A rank of phase 8 (``chip_smoke.py --phase8-rank WHICH RANK WORLD
    PORT DIR``): joins the gloo group on the card, runs its part and saves
    what it measured to DIR/p8_<which>_rank<r>.pt."""
    which, rank, world, port, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.parallel.distributed import local_rank, maybe_initialize
    from btia_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    # The parent built the library (phase 1); a rank only loads it.
    if not (_native.BUILD_ROOT / _native.source_hash() / _native.LIB_NAME).exists():
        raise RuntimeError("phase 8: the kernel library is not built; phase 1 builds it before the ranks start")
    maybe_initialize(f"127.0.0.1:{port}", world, rank, backend=P8_BACKEND, timeout_s=P8_GLOO_TIMEOUT_S)
    local_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    if which in ("serve", "tp_train"):  # streaming_vitl's registered mesh: data -1, model 2
        mc = get_config("streaming_vitl").mesh
        mesh = make_mesh(MeshConfig(mc.data, mc.model))
        out = _p8_rank_serve(torch, dev, mesh, tmp) if which == "serve" else p8e_train_step(torch, dev, mesh)
    else:
        mesh = make_mesh(MeshConfig(data=-1, model=1))
        out = p8_train_steps(torch, dev, mesh)
    out["mesh"] = dict(mesh.shape)
    torch.save(out, tmp / f"p8_{which}_rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _p8_spawn(torch, which, tmp, world=2):
    """Start `world` ranks of phase 8 on the card and wait for them, each
    with a timeout; a rank that fails or outlives it fails the phase."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        f = open(tmp / f"p8_{which}_rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--phase8-rank", which,
                                        str(r), str(world), str(port), str(tmp)],
                                       stdout=f, stderr=subprocess.STDOUT, cwd=REPO), f))
    failed = []
    deadline = time.monotonic() + P8_RANK_TIMEOUT_S
    for r, (p, f) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
                q.wait()
            rc = "timeout"
        f.close()
        if rc != 0:
            failed.append((r, rc))
    if failed:
        tails = "\n".join(f"--- rank {r} ({rc}):\n" + (tmp / f"p8_{which}_rank{r}.log").read_text()[-3000:]
                          for r, rc in failed)
        raise AssertionError(f"phase 8 {which}: rank(s) failed:\n{tails}")
    return [torch.load(tmp / f"p8_{which}_rank{r}.pt", weights_only=False) for r in range(world)]


def mesh_phase(torch, dev, smi):
    """Phase 8: the (data, model) mesh as two gloo ranks on the one card.

    8a: full-width streaming_vitl under its registered mesh (world 2 ->
    data 1, model 2) through make_sharded_serve_fn at 4 images x 64
    questions (256 question rows a rank), against the one-process serve step
    on the card with the same seeded weights: logits within a tenth of the
    largest, each rank's K1/K2/K3 launches, the bytes all-reduced a step
    beside the reckoning of ``p8_reckoned_bytes``, each rank's peak memory
    beside the one-process step's, the step time. 8b: Predictor(mesh=) on
    that model, predict_batch / predict against one-process Predictor's.
    8d: the same seeded weights with int8 FFNs under the same mesh (in the
    same ranks, after 8b) against the one-process int8 step on the card:
    logits within a tenth of the largest, K1 20 / K2 1 / K3 24 / K7 86 / K8
    90 a rank, the bytes all-reduced a step equal to ``p8_reckoned_bytes``.
    8e: one TP train step of streaming_vitl at registered widths, depth cut
    (``tp_train_phase``).
    8c: one DP (2, 1) vqa_rad_lstm train step at a global batch of 128 (64 a
    rank) against the one-process step at 128, at dropout 0, bf16 and fp32:
    loss, global norm, the applied gradients and BatchNorm statistics within
    phase 6's bounds (``P8_TRAIN_BOUNDS``), every parameter within 2.5
    learning rates of the one-process one; bf16 K1 4 / K4 4 / K7 14 a rank, fp32 the
    one-process step's counts (K1 and K4 on the CUDA-core kernels)."""
    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.models.model import build_model

    log(f"phase 8: the mesh, backend {P8_BACKEND!r}: {P8_CAVEAT}")
    counters = launch_counters() + new_counters()
    res = {"backend": P8_BACKEND, "caveat": P8_CAVEAT, "card": smi}
    cfg = get_config("streaming_vitl")
    rng = np.random.RandomState(80)
    size = max(256, cfg.model.image_size)
    corpus = ["is the lung normal", "what organ is shown", "is there a fracture", "which side is the lesion on",
              "does the chest show pleural effusion", "is this an mri", "where is the mass"]
    inp = {"images": rng.randint(0, 256, (P8_IMAGES, size, size, 3)).astype(np.uint8),
           "qids": rng.randint(1, cfg.model.bert_vocab_size, (P8_IMAGES, P8_QUESTIONS, cfg.model.max_question_len)
                               ).astype(np.int64),
           "image": rng.randint(0, 256, (size, size, 3)).astype(np.uint8), "corpus": corpus,
           "answers": [f"answer {i}" for i in range(300)]}
    # The one-process references on the card, same seeded weights. Its peak
    # is counted from what this process held before the model, as a rank's
    # from nothing.
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model = build_model(cfg.model, device=dev, seed=0)
    with torch.inference_mode():
        imgs, qids = torch.from_numpy(inp["images"]).to(dev), torch.from_numpy(inp["qids"]).to(dev)
        model.answer_questions(model.encode_image(imgs), qids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = model.answer_questions(model.encode_image(imgs), qids).float().cpu()
        one_ms = 1e3 * (time.perf_counter() - t0)
        one_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    pred = Predictor(model, None, WordPieceTokenizer.toy_vocab(corpus), AnswerVocab(inp["answers"]), cfg, device=dev)
    ref_batch = pred.predict_batch(inp["image"], corpus)
    del pred, model
    torch.cuda.empty_cache()
    cfg8 = get_config("streaming_vitl", **{"model.int8_ffn": True})
    model8 = build_model(cfg8.model, device=dev, seed=0)
    with torch.inference_mode():
        ref8 = model8.answer_questions(model8.encode_image(imgs), qids).float().cpu()
    del model8, imgs, qids
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p8_") as tmp:
        tmp = Path(tmp)
        torch.save(inp, tmp / "p8_serve_inputs.pt")
        t0 = time.perf_counter()
        ranks = _p8_spawn(torch, "serve", tmp)
        spawn_s = time.perf_counter() - t0
        reckoned = p8_reckoned_bytes(cfg, P8_IMAGES, P8_QUESTIONS)
        scale = ref.abs().max().item()
        serve = {"images": P8_IMAGES, "questions_per_image": P8_QUESTIONS, "mesh": ranks[0]["mesh"],
                 "one_process_ms": one_ms, "one_process_peak_gib": one_peak,
                 "max_abs_logit": scale,
                 "reckoned_bytes_per_step": reckoned, "ranks_wall_s": spawn_s, "ranks": []}
        for r, o in enumerate(ranks):
            err = (o["logits"] - ref).abs().max().item()
            b_err = float(np.abs(o["predict_batch"] - ref_batch).max())
            p_err = float(np.abs(o["predict"] - ref_batch[0]).max())
            reduced = o["reduced"].get("model", {"calls": 0, "bytes": 0})
            row = {"rank": r, "max_abs_err": err, "counts": dict(zip(KERNELS + NEW_KERNELS, o["counts"])),
                   "all_reduce_calls": reduced["calls"], "all_reduced_bytes": reduced["bytes"],
                   "peak_gib": o["peak_gib"], "param_gib": o["param_gib"], "ms_per_step": o["ms_per_step"],
                   "pairs_per_s": P8_IMAGES * P8_QUESTIONS / (o["ms_per_step"] / 1e3),
                   "predict_batch_max_abs_err": b_err, "predict_max_abs_err": p_err,
                   "predict_answers": o["predict_answers"],
                   "predict_counts": dict(zip(KERNELS + NEW_KERNELS, o["predict_counts"]))}
            serve["ranks"].append(row)
            log(f"  8a rank {r}: logits vs one process max abs err {err:.4g} (max |logit| {scale:.4g}); launched "
                f"{o['counts']}; all-reduced {reduced['bytes']} B in {reduced['calls']} calls (reckoned "
                f"{reckoned} B); peak {o['peak_gib']:.2f} GiB vs one process {one_peak:.2f} GiB; "
                f"{o['ms_per_step']:.1f} ms a step vs one process {one_ms:.1f} ms ({P8_CAVEAT})")
            log(f"  8b rank {r}: Predictor(mesh=) predict_batch err {b_err:.4g}, predict err {p_err:.4g}, "
                f"answers {o['predict_answers'][:3]}")
            if o["counts"] != P8_SERVE_COUNTS:
                raise AssertionError(f"phase 8a rank {r}: launch counts {o['counts']} != {P8_SERVE_COUNTS}")
            if not (np.isfinite(o["logits"].numpy()).all() and err <= 0.1 * scale):
                raise AssertionError(f"phase 8a rank {r}: logits disagree with one process: {err} > {0.1 * scale}")
            if reduced["bytes"] != reckoned:
                raise AssertionError(f"phase 8a rank {r}: all-reduced {reduced['bytes']} B != reckoned {reckoned}")
            bscale = float(np.abs(ref_batch).max())
            if not (b_err <= 0.1 * bscale and p_err <= 0.1 * bscale and len(o["predict_answers"]) == len(corpus)):
                raise AssertionError(f"phase 8b rank {r}: Predictor(mesh=) disagrees: {b_err}, {p_err}")
        res["serve"] = serve
        # 8d: int8 FFNs under the same mesh against the one-process int8 step.
        reckoned8 = p8_reckoned_bytes(cfg8, P8_IMAGES, P8_QUESTIONS)
        scale8 = ref8.abs().max().item()
        int8 = {"max_abs_logit": scale8, "reckoned_bytes_per_step": reckoned8, "ranks": []}
        for r, o in enumerate(x["int8"] for x in ranks):
            err = (o["logits"] - ref8).abs().max().item()
            reduced = o["reduced"].get("model", {"calls": 0, "bytes": 0})
            int8["ranks"].append({"rank": r, "max_abs_err": err, "counts": dict(zip(KERNELS + NEW_KERNELS, o["counts"])),
                                  "all_reduce_calls": reduced["calls"], "all_reduced_bytes": reduced["bytes"],
                                  "ms_per_step": o["ms_per_step"]})
            log(f"  8d rank {r}: int8 logits vs one process max abs err {err:.4g} (max |logit| {scale8:.4g}); "
                f"launched {o['counts']}; all-reduced {reduced['bytes']} B in {reduced['calls']} calls (reckoned "
                f"{reckoned8} B); {o['ms_per_step']:.1f} ms a step ({P8_CAVEAT})")
            if o["counts"] != P8_INT8_COUNTS:
                raise AssertionError(f"phase 8d rank {r}: launch counts {o['counts']} != {P8_INT8_COUNTS}")
            if not (np.isfinite(o["logits"].numpy()).all() and err <= 0.1 * scale8):
                raise AssertionError(f"phase 8d rank {r}: int8 logits disagree with one process: {err} > {0.1 * scale8}")
            if reduced["bytes"] != reckoned8:
                raise AssertionError(f"phase 8d rank {r}: all-reduced {reduced['bytes']} B != reckoned {reckoned8}")
        res["int8"] = int8
        # 8e: the TP train step.
        res["tp_train"] = tp_train_phase(torch, dev, smi, tmp)
        # 8c: the DP train step.
        one = p8_train_steps(torch, dev)
        t0 = time.perf_counter()
        ranks = _p8_spawn(torch, "train", tmp)
        spawn_s = time.perf_counter() - t0
    train = {"batch": P8_BATCH, "ranks_wall_s": spawn_s}
    for policy, bounds in P8_TRAIN_BOUNDS.items():
        ref = one[policy]
        names = [n for n in ref["grads"] if not n.endswith("k_proj.bias")]  # 0 in exact arithmetic
        enc = [n for n in names if n.startswith("image_encoder.")]
        rest = [n for n in names if n not in enc]
        stats = [n for n in ref["state"] if n.endswith((".mean", ".var"))]
        t = train[policy] = {"one_process": {k: ref[k] for k in ("counts", "seconds", "warm_seconds", "peak_gib",
                                                                 "metrics")}, "ranks": []}
        for r, o in enumerate(x[policy] for x in ranks):
            m, w = o["metrics"], ref["metrics"]
            row = {"rank": r, "rows": o["rows"], "counts": dict(zip(KERNELS + NEW_KERNELS, o["counts"])),
                   "metrics": m, "seconds": o["seconds"], "warm_seconds": o["warm_seconds"], "peak_gib": o["peak_gib"],
                   "loss_rel": abs(m["loss"] - w["loss"]) / abs(w["loss"]),
                   "grad_norm_rel": abs(m["grad_norm"] - w["grad_norm"]) / w["grad_norm"],
                   "grad_rel_l2_encoder": _rel_l2(o["grads"], ref["grads"], enc),
                   "grad_rel_l2_rest": _rel_l2(o["grads"], ref["grads"], rest),
                   "bn_stats_rel_l2": _rel_l2(o["state"], ref["state"], stats),
                   "param_max_abs_diff_over_lr": max((o["state"][n] - ref["state"][n]).abs().max().item()
                                                     for n in ref["grads"]) / ref["lr"]}
            t["ranks"].append(row)
            log(f"  8c {policy} rank {r} ({o['rows']} rows): "
                f"{json.dumps({k: v for k, v in row.items() if k != 'metrics'})}")
            bad = {k: row[k] for k, bound in bounds.items() if not row[k] <= bound}
            if bad:
                raise AssertionError(f"phase 8c {policy} rank {r}: the DP step disagrees with the one-process "
                                     f"step past {bounds}: {bad}")
            want = P8_TRAIN_COUNTS if policy == "bf16" else ref["counts"]
            if o["counts"] != want or (policy == "bf16" and ref["counts"] != want):
                raise AssertionError(f"phase 8c {policy}: launch counts {o['counts']} / one process "
                                     f"{ref['counts']} != {want}")
        log(f"  8c {policy} one process at {P8_BATCH} rows: {ref['seconds']:.3f} s (warm {ref['warm_seconds']:.3f}), "
            f"peak {ref['peak_gib']:.2f} GiB; ranks warm {[round(r['warm_seconds'], 3) for r in t['ranks']]} s, peak "
            f"{[round(r['peak_gib'], 2) for r in t['ranks']]} GiB ({P8_CAVEAT})")
    res["train"] = train
    log(json.dumps({"mesh_phase": res}))
    return res


# ---------------------------------------------------------------------------
# --train-mesh: training over the (data, model) mesh on several cards.

# (config, ranks, mesh overrides): vqa_med_full under its registered mesh
# (data -1, model 1: data-parallel over the ranks) on 1, 2 and 4 cards;
# streaming_vitl under its registered mesh (data -1, model 2) on 4 cards,
# (2, 2), and on one card with its model axis cut to 1.
TM_RUNS = (("vqa_med_full", 1, ()), ("vqa_med_full", 2, ()), ("vqa_med_full", 4, ()),
           ("streaming_vitl", 1, ("mesh.model=1",)), ("streaming_vitl", 4, ()))
# Each run: one epoch of its registered batch (64 pairs) on a synthetic
# corpus of about TM_STEPS steps, a step at a time and each step's loss
# logged (dropout 0, the registered warmup cut to 2 steps, one checkpoint
# kept); its time a step is the median gap between the logged steps after
# the first TM_WARM.
TM_STEPS, TM_WARM = 12, 2
TM_SETS = ("train.epochs=1", "train.steps_per_call=1", "train.log_every=1", "model.dropout=0.0",
           "train.warmup_steps=2", "train.keep_checkpoints=1")
TM_RUN_TIMEOUT_S = 600


def _tm_run(config, ranks, sets, data_dir, work, log_dir):
    """One ``cli train`` run: in this process's interpreter on one card, or
    under ``torch.distributed.run`` with NCCL, one card a rank, its output
    in ``log_dir`` (the tail raised if it fails). Returns its train rows, its
    epoch row (``metrics.jsonl``) and its wall time."""
    import socket

    cli = ["-m", "btia_tpu_torch.cli", "train", "--config", config, "--workdir", str(work),
           *[a for x in (f"data.data_dir={data_dir}", *TM_SETS, *sets) for a in ("--set", x)]]
    if ranks > 1:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(ranks),
               "--master-addr", "127.0.0.1", "--master-port", str(port), *cli]
    else:
        cmd = [sys.executable, *cli]
    t0 = time.perf_counter()
    with open(log_dir / f"{config}_{ranks}.log", "w") as f:
        proc = subprocess.run(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT, timeout=TM_RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        tail = (log_dir / f"{config}_{ranks}.log").read_text()[-3000:]
        raise AssertionError(f"cli train {config} on {ranks} card(s) exited {proc.returncode}:\n{tail}")
    rows = [json.loads(ln) for ln in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if r.get("split") == "train"]
    epoch = [r for r in rows if r.get("split") == "epoch"]
    if not steps or len(epoch) != 1:
        raise AssertionError(f"cli train {config} on {ranks} card(s): no step or epoch rows in {work}")
    return steps, epoch[0], wall


def train_mesh_main() -> int:
    """``python3 chip_smoke.py --train-mesh``: ``cli train`` under
    ``torch.distributed.run`` (NCCL, one card a rank) for each of TM_RUNS
    that the host's cards allow, against the same run on one card: ms a
    step, examples/s a card, the peak memory of rank 0's card (the Trainer's
    epoch row), and each step's loss against one card's. Prints a JSON line
    a run, then ``{"train_mesh": ...}``; on one card, the one-card runs
    only."""
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --train-mesh: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from btia_tpu_torch.cli import _parse_overrides as _parse_sets
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.synthetic import generate_synthetic_dataset, generate_synthetic_vqa_med
    from btia_tpu_torch.ops import _native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    cards = torch.cuda.device_count()
    log(f"train-mesh: {cards} cards: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # Built once here; the ranks find the library and only load it.
    log(f"train-mesh: built the kernels in {_native.timed_build():.1f} s")
    out = {"cards": smi, "runs": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tm_") as tmp:
        tmp = Path(tmp)
        # By dataset: VQA-Med 2 training pairs an image; VQA-RAD 4 an image,
        # about 3/4 of them for training.
        data = {"vqa_med": generate_synthetic_vqa_med(tmp / "vqa_med", num_images=32 * TM_STEPS),
                "vqa_rad": tmp / "vqa_rad"}
        generate_synthetic_dataset(data["vqa_rad"], num_images=22 * TM_STEPS, qa_per_image=4)
        one = {}
        for config, ranks, sets in TM_RUNS:
            if ranks > cards:
                log(f"train-mesh: {config} on {ranks} cards skipped: {cards} on this host")
                continue
            cfg = get_config(config, **_parse_sets(sets))
            steps, epoch, wall = _tm_run(config, ranks, sets, data[cfg.data.dataset], tmp / f"{config}_{ranks}",
                                         tmp)
            ts = [r["ts"] for r in steps]
            gaps = [b - a for a, b in zip(ts, ts[1:])][TM_WARM:]
            ms = 1e3 * statistics.median(gaps) if gaps else float("nan")
            batch = cfg.train.batch_size
            run = {"config": config, "ranks": ranks, "sets": list(sets), "steps": len(steps),
                   "ms_per_step": ms, "examples_per_s_per_card": batch / (ms / 1e3) / ranks,
                   "epoch_examples_per_s": epoch["examples_per_sec"], "peak_mem_gib_rank0": epoch.get("peak_mem_gib"),
                   "losses": [r["loss"] for r in steps], "grad_norms": [r["grad_norm"] for r in steps],
                   "val_accuracy": epoch.get("val_accuracy"), "wall_s": wall}
            if ranks == 1:
                one[config] = run
            elif config in one:
                ref = one[config]
                n = min(len(ref["losses"]), len(run["losses"]))
                run["loss_rel_vs_one_card"] = [abs(a - b) / abs(b) for a, b in zip(run["losses"][:n], ref["losses"][:n])]
                run["ms_per_step_vs_one_card"] = ms / ref["ms_per_step"]
                run["examples_per_s_per_card_vs_one_card"] = (run["examples_per_s_per_card"]
                                                              / ref["examples_per_s_per_card"])
            log(json.dumps({"train_mesh_run": run}))
            out["runs"].append(run)
    log(json.dumps({"train_mesh": out}))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "btia_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: btia_tpu_torch/ not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    global T0
    T0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.models.layers import Dense
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.ops import gemm as G

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 1: build.
    log(f"phase 1: built the kernels in {_native.timed_build():.1f} s ({_native.build()})")

    # Phase 2: kernels against their plain twins.
    log("phase 2: kernels vs plain twins (bf16, serving-step shapes)")
    rows = check_kernels(torch, dev)
    core_rows, core_step = check_core(torch, dev)
    gemm_rows, gemm_step = check_gemm(torch, dev)
    mlp_rows, mlp_step = check_mlp_gemm(torch, dev)
    moe_rows, moe_launches = check_moe_gemm(torch, dev)
    mla_row, mla_launches = check_mla_attn(torch, dev)
    edges = check_persistent_edges(torch, dev)
    int8_rows = check_int8_kernel(torch, dev)
    counters = launch_counters()
    ops_rows, ops_counts = ops_api_phase(torch, dev, counters)
    rows.update(ops_rows)
    simt_attn, wide_attn, simt_gemm = check_simt(torch, dev)
    wide_ptx = wide_ptxas()
    log(f"  (phase 2c done at {time.perf_counter() - T0:.0f} s)")

    # Phase 3: Predictor on full-width streaming_vitl.
    cfg = get_config("streaming_vitl")
    t0 = time.perf_counter()
    model = build_model(cfg.model, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"phase 3: built streaming_vitl ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) in {time.perf_counter() - t0:.1f} s")
    corpus = [
        "is the lung normal", "what organ is shown", "is there a fracture",
        "which side is the lesion on", "does the chest show pleural effusion",
        "is this an mri", "where is the mass", "is the heart enlarged",
    ]
    tok = WordPieceTokenizer.toy_vocab(corpus)
    answers = AnswerVocab([f"answer {i}" for i in range(300)])
    pred = Predictor(model, None, tok, answers, cfg, device=dev)
    rng = np.random.RandomState(0)
    size = pred.ingest_size
    images = [rng.randint(0, 256, (size, size, 3)).astype(np.uint8) for _ in range(3)]
    _zero(counters)
    for img, n in zip(images, (1, 5, 8)):
        logits = pred.predict_batch(img, corpus[:n])
        if logits.shape != (n, cfg.model.answer_vocab_size) or not np.isfinite(logits).all():
            raise AssertionError(f"predict_batch: bad logits {logits.shape}")
        got = pred.predict_answers(img, corpus[:n])
        if len(got) != n or not all(a.startswith("answer ") for a in got):
            raise AssertionError(f"predict_answers returned {got}")
        log(f"  image of {n} question(s): {got}")
    counts = [f.launches for f in counters]
    log("  six Predictor calls launched " + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts)))
    if counts != [6 * c for c in PREDICT_COUNTS]:
        raise AssertionError(f"Predictor launch counts {counts} != {[6 * c for c in PREDICT_COUNTS]}")
    # The same model on the CPU (plain twins) as the reference.
    ref_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        ids = torch.from_numpy(pred._tokenize(corpus[:2]))[None]
        img_t = torch.from_numpy(images[0])[None]
        out_gpu = model.answer_questions(model.encode_image(img_t.to(dev)), ids.to(dev)).cpu()
        out_cpu = ref_model.answer_questions(ref_model.encode_image(img_t), ids)
    del ref_model
    err = (out_gpu - out_cpu).abs().max().item()
    scale = out_cpu.abs().max().item()
    # bf16 roundings differ between the card's kernels and the CPU's plain
    # twins in every one of the 40 layers; hold the logits to a tenth of
    # their own largest magnitude.
    log(f"  card vs CPU logits: max abs err {err:.4g} at max |logit| {scale:.4g}")
    if not err <= 0.1 * scale:
        raise AssertionError(f"card and CPU logits disagree: {err} > {0.1 * scale}")

    # Phase 4: the bench-shaped serve step.
    L = cfg.model.max_question_len
    host_imgs = [rng.randint(0, 256, (B_IMG, size, size, 3)).astype(np.uint8) for _ in range(2)]
    host_qids = [rng.randint(1, cfg.model.bert_vocab_size, (B_IMG, N_Q, L)).astype(np.int64)
                 for _ in range(2)]
    serve_step = serve_step_fn(torch, dev, model, host_imgs, host_qids, cfg.model.answer_vocab_size)

    torch.cuda.synchronize()
    _zero(counters)
    dense_before = (Dense.epilogue_calls, Dense.chain_calls)
    vals, idx = serve_step(0)
    torch.cuda.synchronize()
    counts = [f.launches for f in counters]
    dense_routes = (Dense.epilogue_calls - dense_before[0], Dense.chain_calls - dense_before[1])
    log("phase 4: one serve step launched " + ", ".join(f"{k} {c}" for k, c in zip(KERNELS, counts))
        + f"; Dense calls on the epilogue GEMM {dense_routes[0]}, on the chain {dense_routes[1]}")
    if counts != SERVE_COUNTS:
        raise AssertionError(f"serve-step launch counts {counts} != {SERVE_COUNTS}")
    if dense_routes != SERVE_DENSE_ROUTES:
        raise AssertionError(f"serve-step Dense routes {dense_routes} != {SERVE_DENSE_ROUTES}")
    if vals.shape != (B_IMG, N_Q, 5) or not np.isfinite(vals).all():
        raise AssertionError("serve step: bad top-k")
    main_counts = counts
    # K1/K2's weights were prepared in the first step; an unchanged model
    # prepares nothing again.
    builds = G.prepare_once.builds
    serve_step(1)
    torch.cuda.synchronize()
    if G.prepare_once.builds != builds:
        raise AssertionError(f"a second serve step prepared {G.prepare_once.builds - builds} weight sets again")
    map_stats = (ctypes.c_longlong * 2)()
    _native.lib().btia_attn_core_map_stats(map_stats)
    maps_before = list(map_stats)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        serve_step(i)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    _native.lib().btia_attn_core_map_stats(map_stats)
    core_maps = {"hits": map_stats[0] - maps_before[0], "misses": map_stats[1] - maps_before[1]}
    if "--profile" in sys.argv[1:]:
        profile_step(torch, lambda: serve_step(0), smi)
    kernel_ms = (12 * rows["bert"]["ms"] + 4 * rows["btia_i2t"]["ms"]
                 + 4 * rows["btia_t2i"]["ms"] + rows["k2"]["ms"] + 24 * rows["k3"]["ms"])
    log(json.dumps({
        "serve_step": {
            "config": "streaming_vitl", "images": B_IMG, "questions_per_image": N_Q,
            "steps": TIMED_STEPS, "ms_per_step": step_ms,
            "pairs_per_s": B_IMG * N_Q / (step_ms / 1e3),
            "ported_kernels_ms_per_step": kernel_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "prepared_weight_sets": len(G._PREPARED), "prepared_weights_mb": G.prepared_bytes() / 1e6,
            "weight_sets_prepared_in_timed_steps": G.prepare_once.builds - builds,
            "core_tensor_maps_in_timed_steps": core_maps,
            "before_k7_ms_per_step": BEFORE_K7_MS["serve"], "card": smi,
        }
    }))
    switches = routing_switches_phase(torch, dev, smi, model, host_imgs, host_qids, serve_step, counters)
    ln_census = layernorm_census(torch, dev, serve_step, counters)

    # Phases 4b and 4c: int8 serving, a timed step and the streaming server.
    model8, cfg8, int8_counts, int8_res = int8_serve_phase(
        torch, dev, smi, model, host_imgs, host_qids, counters)
    del pred, model
    torch.cuda.empty_cache()
    stream = streaming_phase(torch, dev, smi, model8, cfg8)
    del model8
    torch.cuda.empty_cache()

    # Phase 5: train vqa_med_full.
    train = train_phase(torch, dev, smi, counters)
    train["train_step"]["card_vs_cpu"] = train_step_vs_cpu(torch, dev, counters)
    log(json.dumps({"train_step": train["train_step"]}))
    wide = wide_heads_phase(torch, dev, smi, counters)
    # From here on every counter: K1..K8, the CUDA-core kernels and the
    # wide-head kernel.
    all_counters = counters + new_counters()
    wide_kernel = wide_heads_phase(torch, dev, smi, all_counters, (WIDE_KERNEL_HEADS,), WIDE_KERNEL_COUNTS, "5d",
                                   timed_steps=5)
    log(f"  (phase 5d done at {time.perf_counter() - T0:.0f} s)")
    pathvqa = pathvqa_phase(torch, dev, smi, counters)
    log(f"  (phase 5c done at {time.perf_counter() - T0:.0f} s)")

    # Phases 6, 6b and 6c: the ResNet / LSTM / mlp-head configs, and the
    # fp32 policy.
    lstm = vqa_rad_lstm_phase(torch, dev, smi, all_counters)
    log(f"  (phase 6 done at {time.perf_counter() - T0:.0f} s)")
    slake = slake_bert_phase(torch, dev, smi, all_counters)
    log(f"  (phase 6b done at {time.perf_counter() - T0:.0f} s)")
    fp32 = fp32_phase(torch, dev, smi, all_counters)
    log(f"  (phase 6c done at {time.perf_counter() - T0:.0f} s)")

    # Phase 7: the user's entry points: the CLI, checkpoint conversion, the
    # bench and model.remat.
    cli = cli_phase(torch, dev, smi, all_counters)
    conv = convert_phase(torch, dev, smi, all_counters)
    benches = bench_phase(torch, dev, smi, all_counters, step_ms, lstm["serve_step"]["ms_per_step"])
    rematr = remat_phase(torch, dev, smi, all_counters)
    prof = profiling_phase(torch, dev, smi, all_counters)
    log(f"  (phase 7 done at {time.perf_counter() - T0:.0f} s)")

    # Phase 8: the mesh, two gloo ranks on the one card.
    torch.cuda.empty_cache()
    mesh = mesh_phase(torch, dev, smi)
    log(f"  (phase 8 done at {time.perf_counter() - T0:.0f} s)")
    new_paths = {
        "vqa_rad_lstm_serve_step": lstm["serve_step"]["launches"],
        "vqa_rad_lstm_train_call": lstm["train_call"]["launches"],
        "slake_bert_serve_step": slake["serve_step"]["launches"],
        "slake_bert_train_step": slake["train_step"]["launches"],
        "fp32_forwards": {k: sum(fp32[c]["launches"][k] for c in ("vqa_rad_lstm", "streaming_vitl", "tiny_test"))
                          for k in KERNELS + NEW_KERNELS},
        "d384_train_step": wide_kernel[768 // WIDE_KERNEL_HEADS]["train_launches"],
        "d384_eval": wide_kernel[768 // WIDE_KERNEL_HEADS]["eval_launches"],
        **{f"cli_{c}": cli[c]["launches"] for c in ("train", "eval", "predict", "serve")},
        "convert_predict": conv["launches"],
        "bench_streaming_vitl": benches["streaming_vitl"]["launches"],
        "bench_vqa_rad_lstm": benches["vqa_rad_lstm"]["launches"],
        "remat_train_step": rematr["launches_remat"],
        "profiled_serve_steps": prof["launches"],
        **{f"mesh_serve_rank{r['rank']}": r["counts"] for r in mesh["serve"]["ranks"]},
        **{f"mesh_predict_rank{r['rank']}": r["predict_counts"] for r in mesh["serve"]["ranks"]},
        **{f"mesh_dp_train_{p}_rank{r['rank']}": r["counts"] for p in ("bf16", "fp32")
           for r in mesh["train"][p]["ranks"]},
        **{f"mesh_dp_train_{p}_one_process": dict(zip(KERNELS + NEW_KERNELS, mesh["train"][p]["one_process"]["counts"]))
           for p in ("bf16", "fp32")},
        **{f"mesh_tp_train_rank{r['rank']}": r["counts"] for r in mesh["tp_train"]["ranks"]},
        "mesh_tp_train_one_process": mesh["tp_train"]["one_process"]["counts"],
    }
    by_path = [{"serve_step": a, "int8_serve_step": c, "train_step": b, "ops_api": d,
                **{p: v[k] for p, v in new_paths.items()}}
               for a, b, c, d, k in zip(main_counts, train["train_counts"], int8_counts, ops_counts, KERNELS)]
    # Each new kernel runs on its own path and no other: the f32 kernels on
    # the fp32 forwards, the wide-head kernel at head width 384 (phase 5d);
    # neither on the bf16 paths at head widths up to 256.
    p8_fp32 = tuple(p for p in new_paths if p.startswith("mesh_dp_train_fp32"))
    own = {"simt_attention": ("fp32_forwards", *p8_fp32), "gemm_f32": ("fp32_forwards", *p8_fp32),
           "wide_attention": ("d384_train_step", "d384_eval")}
    for k, paths in own.items():
        if not all(new_paths[p][k] for p in paths):
            raise AssertionError(f"{k} was not launched on its path {paths}: {new_paths}")
        if any(v[k] for p, v in new_paths.items() if p not in paths):
            raise AssertionError(f"{k} was launched off its path {paths}: {new_paths}")
    widths = [768 // h for h in WIDE_HEADS]
    k1_sites = ("bert", "btia_i2t", "btia_t2i", "med_bert", "med_i2t", "med_t2i",
                *(f"med_{site}_d{hw}" for hw in widths for site in ("bert", "i2t")))
    entries = [
        ("fused_dense_attention", "btia_tpu_torch/csrc/fused_attn.cu",
         "btia_tpu/ops/fused_attn.py:179", 0, rows["bert"], k1_sites, "K1_backward"),
        ("fused_static_q_attention", "btia_tpu_torch/csrc/fused_attn.cu",
         "btia_tpu/ops/fused_attn.py:561", 1, rows["k2"], ("k2", *(f"k2_d{hw}" for hw in widths)), "K2_backward"),
        ("bshd_flash_attention", "btia_tpu_torch/csrc/flash_bshd.cu",
         "btia_tpu/ops/attention.py:563", 2, rows["k3"],
         ("k3", "k3_vitb", "k3_head", *(f"k3_head_d{hw}" for hw in widths)),
         "K3_backward"),
        ("fanout_attention", "btia_tpu_torch/csrc/fanout.cu",
         "btia_tpu/ops/attention.py:349", 3, rows["k4_bert"],
         ("k4_bert", "k4_i2t", "k4_t2i", *(f"k4_i2t_d{hw}" for hw in widths), *(n for n, *_ in K4_SERVE_SHAPES)),
         "K4_backward"),
        ("mha_bhsd_attention", "btia_tpu_torch/csrc/mha_bhsd.cu",
         "btia_tpu/ops/attention.py:160", 4, rows["k5_vitl"], ("k5_vitl", "k5_head"), "K5_backward"),
        ("bicross_bhsd_attention", "btia_tpu_torch/csrc/bicross.cu",
         "btia_tpu/ops/bicross.py:87", 5, rows["k6_pooled"], ("k6_pooled", "k6_long"), "K6_backward"),
        ("layernorm", "btia_tpu_torch/csrc/layernorm.cu", "btia_tpu/ops/norms.py:30", 6,
         rows["k7_head"], tuple(f"k7_{n}" for n, _, _ in K7_SHAPES) + ("k7_vit_l_f32",), "K7_backward"),
    ]
    kernels = []
    for name, src, replaces, i, r, sites, bwd in entries:
        e = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": sum(by_path[i].values()), "launches_by_path": by_path[i],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"], "backward": rows[bwd]}
        if sites:
            e["sites"] = {s: rows[s] for s in sites}
        kernels.append(e)
    kernels[6]["serve_step_layernorms"] = ln_census
    kernels[6]["entries"] = "layernorm (the models' LayerNorms) and layernorm_fast (the ops API), counted together"
    kernels[6]["wide_rows"] = {D: rows[f"k7_wide_{D}"] for D in (1500, 4096, 6144, 8192)}
    # K1/K2's projection GEMM, alone at the serve shapes (both launch it),
    # and their attention core alone on the short-sequence kernel.
    kernels[0]["projection_gemm"] = {"sites": gemm_rows, "per_step": gemm_step, "edges": edges["gemm"],
                                     "mlp_sites": mlp_rows, "mlp_per_step": mlp_step}
    kernels[2]["persistent_edges"] = edges["k3"]
    kernels[4]["persistent_edges"] = edges["k5"]
    for i, prefix in ((0, ("serve_bert", "serve_i2t", "serve_t2i", "train_")), (1, ("serve_k2",))):
        kernels[i]["attention_core"] = {
            "kernel_source": "btia_tpu_torch/csrc/short_flash.cuh", "entry": "btia_tpu_torch/csrc/fused_attn.cu",
            "sites": {n: r for n, r in core_rows.items() if n.startswith(prefix)},
        }
    kernels[0]["attention_core"]["per_step"] = core_step
    kernels[4]["kernel_source"] = "btia_tpu_torch/csrc/flash_bshd.cu"  # K5's entry runs K3's kernel
    for i in (3, 5):  # K4's and K6's entries run the short-sequence kernel
        kernels[i]["kernel_source"] = "btia_tpu_torch/csrc/short_flash.cuh"
    r = int8_rows["txt_fc1"]  # the BERT / BTIA-text fc1 shape, 16 launches a step
    kernels.append({
        "name": "int8_matmul_fused", "route": "cuda", "source": "btia_tpu_torch/csrc/int8_mm.cu",
        "replaces": "btia_tpu/ops/quant.py:87", "launches": sum(by_path[7].values()),
        "launches_by_path": by_path[7], "max_abs_err": max(x["max_abs_err"] for x in int8_rows.values()),
        "ms": r["ms"], "road_ms": r["road_ms"], "quantize_ms": r["quantize_ms"], "gemm_ms": r["gemm_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "library": r["library"], "bf16_matmul_ms": r["bf16_matmul_ms"],
        "ms_per_step": sum(x["ms"] * x["launches_per_step"] for x in int8_rows.values()),
        "road_ms_per_step": sum(x["road_ms"] * x["launches_per_step"] for x in int8_rows.values()),
        "bound_ms_per_step": sum(x["bound_ms"] * x["launches_per_step"] for x in int8_rows.values()),
        "sites": int8_rows,
    })
    bwd_rows = {k: v for k, v in rows.items() if k.startswith("k7_bwd_")}
    r = bwd_rows["k7_bwd_vit_b"]  # ViT-B's 12608 x 768 bf16 rows, 25 launches of a vqa_med_full train step
    kernels.append({
        "name": "layernorm_backward", "route": "cuda", "source": "btia_tpu_torch/csrc/layernorm.cu",
        "replaces": "btia_tpu/ops/norms.py:98 (_layernorm_fast_bwd, the backward of K7's custom_vjp)",
        "launches": sum(by_path[8].values()), "launches_by_path": by_path[8],
        "max_abs_err": max(x["max_abs_err"] for x in bwd_rows.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "library": "torch.ops.aten.native_layer_norm_backward",
        "sites": bwd_rows, "through_autograd": rows["K7_backward"],
        "where_the_clamp_cuts": {k: v for k, v in rows.items() if k.startswith("k7_clamp_bwd_")},
    })
    r = moe_rows["swiglu"]
    kernels.append({
        "name": "grouped_gemm", "route": "cuda", "source": "btia_tpu_torch/csrc/moe_gemm.cu",
        "replaces": "none (the JAX package has no MoE layer)", "launches": moe_launches,
        "launches_by_path": {"moe_layer": moe_launches},
        "max_abs_err": max(x["max_abs_err"] for x in moe_rows.values()), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "library": "per-expert bf16 torch.mm loop",
        "ms_per_layer": sum(x["ms"] for x in moe_rows.values()),
        "library_ms_per_layer": sum(x["library_ms"] for x in moe_rows.values()),
        "bound_ms_per_layer": sum(x["bound_ms"] for x in moe_rows.values()),
        "sites": moe_rows,
    })
    kernels.append({
        "name": "mla_attention", "route": "cuda", "source": "btia_tpu_torch/csrc/mla_attn.cu",
        "replaces": "none (the JAX package has no MLA)", "launches": mla_launches,
        "launches_by_path": {"mla_layer": mla_launches},
        "max_abs_err": mla_row["max_abs_err"], "ms": mla_row["ms"], "entry_ms": mla_row["entry_ms"],
        "plain_ms": mla_row["plain_ms"], "bound_ms": mla_row["bound_ms"], "bound_by": mla_row["bound_by"],
        "library_ms": None, "library": "none: no PyTorch call computes the packed causal core",
        "sites": {"serve": mla_row},
    })
    for name, rep, src, replaces, sites in (
        ("simt_attention", "k1_core_f32_i2t", "btia_tpu_torch/csrc/attn_simt.cu",
         "btia_tpu/ops/fused_attn.py:179, btia_tpu/ops/fused_attn.py:561, btia_tpu/ops/attention.py:563, "
         "btia_tpu/ops/attention.py:349, btia_tpu/ops/attention.py:160, btia_tpu/ops/bicross.py:87 "
         "(K1-K6 on f32 operands)", simt_attn),
        ("gemm_f32", "lstm_i2t_q", "btia_tpu_torch/csrc/gemm_f32.cu",
         "btia_tpu/ops/fused_attn.py:179, btia_tpu/ops/fused_attn.py:561 (K1/K2's projections on f32 operands)",
         simt_gemm),
        ("wide_attention", "core_bf16_d384", "btia_tpu_torch/csrc/attn_wide.cu",
         "btia_tpu/ops/fused_attn.py:179, btia_tpu/ops/fused_attn.py:561, btia_tpu/ops/attention.py:563, "
         "btia_tpu/ops/attention.py:349, btia_tpu/ops/attention.py:160, btia_tpu/ops/bicross.py:87 "
         "(K1-K6 on bf16 heads of 257-1024)", wide_attn),
    ):
        r = sites[rep]
        paths = {p: v[name] for p, v in new_paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": "F.linear (TF32 off)" if name == "gemm_f32" else "F.scaled_dot_product_attention",
            **({"c_entry_ms": r["c_entry_ms"], "host_share_us": r["host_share_us"], "ptxas": wide_ptx}
               if name == "wide_attention" else {}),
            "sites": sites,
        })
    log(json.dumps({"summary": {
        "vqa_rad_lstm_serve_ms": lstm["serve_step"]["ms_per_step"],
        "vqa_rad_lstm_pairs_per_s": lstm["serve_step"]["pairs_per_s"],
        "vqa_rad_lstm_train_ms_per_step": lstm["train_call"]["ms_per_step"],
        "fp32_card_vs_cpu": {c: [fp32[c].get("card_vs_cpu_max_abs_err"), fp32[c].get("card_vs_cpu_max_logit")]
                             for c in ("vqa_rad_lstm", "streaming_vitl")},
        "fp32_ms": [fp32["vqa_rad_lstm"]["ms_per_forward"], fp32["streaming_vitl"]["ms_per_step"]],
        "elapsed_s": time.perf_counter() - T0,
        "serve_ms": step_ms, "int8_serve_ms": int8_res["ms_per_step"],
        "train_ms": train["train_step"]["ms_per_step"],
        "wide_heads": {hw: [r["eval_card_vs_cpu_max_abs_err"], r["eval_max_logit"]] for hw, r in wide.items()},
        "pathvqa_vit": [pathvqa["eval_card_vs_cpu_max_abs_err"], pathvqa["eval_max_logit"]],
        "wide_kernel_d384": [wide_kernel[768 // WIDE_KERNEL_HEADS][k] for k in ("eval_card_vs_cpu_max_abs_err",
                                                                               "eval_max_logit")],
        "gemm_ms_per_step": gemm_step,
        "mlp_gemm_ms_per_step": mlp_step,
        "core_ms_per_step": core_step,
        "serve_ms_by_switch": {w: v["ms_per_step"] for w, v in switches.items()},
        "serve_layernorms": [ln_census["standalone_layernorms"], ln_census["k7_ms_per_step"],
                             ln_census["plain_ms_per_step"]],
        # Each step's ms on K7's LayerNorms and, in the same run, on the plain
        # formula (the road before), with the logits' largest change.
        "k7_vs_plain_layernorms_ms": {
            "serve": [step_ms, switches["plain LayerNorms"]["ms_per_step"],
                      switches["plain LayerNorms"]["logits_max_abs_err_vs_default"]],
            **{name: [r["plain_layernorms"]["k7_ms_per_step"], r["plain_layernorms"]["ms_per_step"],
                      r["plain_layernorms"][err]]
               for name, r, err in (("int8_serve", int8_res, "logits_max_abs_err_vs_k7"),
                                    ("train", train["train_step"], "eval_logits_max_abs_err_vs_k7"),
                                    ("vqa_rad_lstm_serve", lstm["serve_step"], "logits_max_abs_err_vs_k7"))},
            "vqa_rad_lstm_train_step": lstm["train_call"]["k7_vs_plain_layernorms_ms_per_step"],
        },
        "before_k7_ms": BEFORE_K7_MS,
        "stream_pairs_per_s": {m: v["pairs_per_s"] for m, v in stream.items()},
        "stream_p50_p99_ms": {m: [v["latency"]["p50_ms"], v["latency"]["p99_ms"]] for m, v in stream.items()},
        "cli_bench": benches["cli_bench"]["stdout"],
        "bench_step_ms": {c: [benches[c]["detail"]["step_ms"], benches[c]["phase_serve_ms"]]
                          for c in ("streaming_vitl", "vqa_rad_lstm")},
        "bench_pairs_per_s": {c: benches[c]["result"]["value"] for c in ("streaming_vitl", "vqa_rad_lstm")},
        "convert_max_abs_diff": conv["max_abs_diff"],
        "timer_vs_host_ms": [prof["timer_mean_ms"], prof["host_ms"]],
        "remat": {k: rematr[k] for k in ("loss", "loss_remat", "grad_max_abs_diff", "max_grad", "ms", "ms_remat",
                                         "peak_gib", "peak_gib_remat")},
        "mesh_serve_ms_per_step": [[r["ms_per_step"] for r in mesh["serve"]["ranks"]],
                                   mesh["serve"]["one_process_ms"], P8_CAVEAT],
        "mesh_serve_peak_gib": [[r["peak_gib"] for r in mesh["serve"]["ranks"]],
                                mesh["serve"]["one_process_peak_gib"]],
        "mesh_all_reduced_bytes": [[r["all_reduced_bytes"] for r in mesh["serve"]["ranks"]],
                                   mesh["serve"]["reckoned_bytes_per_step"]],
        "mesh_tp_train": [{k: r[k] for k in ("loss_rel", "grad_norm_rel", "param_max_abs_diff_over_lr", "peak_gib",
                                             "warm_seconds")} for r in mesh["tp_train"]["ranks"]]
        + [{k: mesh["tp_train"]["one_process"][k] for k in ("peak_gib", "warm_seconds")}],
        "mesh_dp_train": {p: [{k: r[k] for k in ("loss_rel", "grad_norm_rel", "grad_rel_l2_rest",
                                                 "grad_rel_l2_encoder", "bn_stats_rel_l2",
                                                 "param_max_abs_diff_over_lr")} for r in mesh["train"][p]["ranks"]]
                          for p in ("bf16", "fp32")},
    }}))
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on a main path: {idle}")
    log(f"total run time {time.perf_counter() - T0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase8-rank"]:
        sys.exit(phase8_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-mesh"]:
        sys.exit(train_mesh_main())
    sys.exit(main())
