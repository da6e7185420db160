#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), versions, kernel build time
     (one nvcc per source, all started together), ptxas warnings,
     registers and spills (per template instance for the two flash
     sources, K1's w4a8_gemm, K6's w4a16_gemm, K7 / K8's w8a16_gemm, K9's
     nvfp4_gemm, K11 / K12's grouped_w4a8_gemm, K2's cluster kernel and
     decode_attention.cu's K5 / K15 / K17 instances; no instance of
     w4a16_gemm.cu, nvfp4_gemm.cu or w8a16_gemm.cu, of K1's decode tile,
     of K17's cluster kernel or of K11's and K12's 8-token tiles may
     spill); TF32 is switched off
     for matmuls and cuDNN, so the MoE router's f32 product runs in full
     f32;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the serving paths' shapes — max abs error against a stated
     tolerance, kernel / plain / library-call times (CUDA events, median of
     25 launches, L2 flushed before each) and the least time the card could
     take for the same work: the MoE kernels (K6 w4a16_gemm at the four
     projection shapes, M = 8 and 544, at M = 32 for N = 4096 and 98304
     and at M = 1 and 16 for N = 512 and K = 4096, N = 2048 (the decode
     tile's cluster split), K10 grouped_w4a16_gemm at M = 1, 8 and 32, K12
     grouped_w4a8_combine_gemm with routed and dense gate scales at M = 8,
     routed at M = 1 and 32, with no row routed and with each used expert
     routed by one row, and at DeepSeek's straddle shape K=1408, K11
     grouped_w4a8_gemm at M = 8, 32, 1 and 16 and at the straddle shape,
     bit for bit, one device kernel a call at M = 8; K10 at the straddle
     shape (64 experts, M = 1, 8, 16, 32) and K6 at K = 1408, N = 2048
     (M = 8, 32, 544), one device kernel a call at M <= 16; K12's shared
     memory as its plan counts it against the kernel's own count), the fp / int8
     weight kernels (K7
     w8a16_gemm and K8 wfp8_gemm at Llama-3-8B's four projections, also at
     M = 1 and 16 for N = 4096, every byte code read back through both
     tiles bit for bit, K9 nvfp4_gemm at Qwen3-30B-A3B's, also at M = 1
     and 16 for N = 4096, K7 / K8 / K9 at the wgmma tile's token-tile edges
     (M = 17, 64, 65, 200, 256 at N = 4096), K13 grouped_nvfp4_gemm at its
     expert down projection, also at M = 1 and 16, K13 at DeepSeek-V2-Lite's
     (64 experts, K = 1408: a 64-row tail; M = 1, 8, 16, 32) and K9 at
     K = 1408, N = 2048 (M = 8, 32, 128), one device kernel a call at
     M <= 16, every (e2m1 code, e4m3
     scale) pair read back through both of K9's tiles bit for bit; one
     device kernel a call for K6 / K10 at M <= 16, K9 / K13 at M = 8 and
     above and K7 / K8 at M = 8, 32 and 128), then K1-K4: K1 at Llama-3-8B's four projections at
     M = 8 and 544 and at its prefill tile's edges (M = 9, 32, 64, 65, 130,
     300 at N = 576, and M = 32 at 4096 x 28672; its decode tile also at
     M = 8 on N = 576 and Qwen3-30B-A3B's decode shapes, at M = 1 and 5,
     and one device kernel a call at M = 8), K2 and K4 at both GQA
     groups the paths run (G = 4 and 8) and on e4m3 caches (K2 also at the
     decode windows' short contexts and at ~512 keys, at S = 2048, eight
     256-key chunks, with positions at chunk and cluster-range edges, and
     on long caches, S = 4096 to 32768; K3 copying e4m3 rows, and its
     two-cache form, an MHA layer's K and V in one launch, at a prefill
     chunk and a decode step; the e4m3 decode of K2 and K15 on all 256
     codes, bit for bit; K4 also at a prompt's first chunk, an unpadded
     second chunk, a ragged row count and with f32 output), then K5 decode_attention at
     the MLA decode shape (KH=1, G=16, D=640, K and V one latent tensor)
     with one chunk and with two, and on a bf16 cache; then K15
     paged_decode_attention at path E's decode shape (int8 pools, e4m3
     pools as on path L, and bf16 off the paths; int8 also at one page a
     slot and over a 128-page table) and path F's (one int8 latent pool
     as K and V), K16 paged_kv_write at a prefill chunk and at
     E's, F's and L's decode steps, and its layer-write entry
     paged_kv_write_rows (page lookup, MLA's zero pad and every pool in one
     launch, bit for bit, one device kernel a call) at E's decode step and
     prefill chunk, F's and L's decode steps, slots past the table's
     capacity with idle slots on the null page, and page ids outside the
     pool, K17
     block_sparse_decode_attention at path J's decode shape (int8 and bf16
     caches, fewer live blocks than in range, lengths mid-block; one and two
     blocks a slot; no live block, blocks wholly past the length; one
     device kernel a call) and K14
     flash_attention at J's calibration forwards (and with windows and
     sinks, one long enough that whole key tiles are skipped, and with
     rows not a multiple of its tile, in f32 and bf16); then the e4m3
     branches: the latent cluster kernel's e4m3 operand decode on all 256
     codes, bit for bit, K5 on e4m3 caches at path N's latent shape (the
     int8 rows' lengths, also against the one-CTA body) and at the MHA
     decodes K2 turns away (KH=2, G=16, D=128 and 256), K17 on e4m3 caches
     at path P's shape (J's rows), one device kernel a call each (K15 on
     path O's e4m3 latent pool is a row of its own phase); then
     int8_dynamic_gemm (no hand-written kernel: per-row int8 codes and
     torch._int_mm, as the reference's XLA dot_general) at a 544-row chunk
     on Llama-3-8B's four projections, bit for bit against its plain
     version, beside the bf16 torch.matmul of the shape;
  then a census of one paged decode forward (a 2-layer llama at E's
     attention geometry, a 2-layer MLA at DeepSeek-V2-Lite's latent row):
     host launch calls and device kernels, K16 once a layer, and neither
     page_slots nor nn.functional.pad called on the card;
  3. parity: small models built from the same numpy weights on the CPU
     (plain versions) and on the card (kernels), prefill and 4 decode steps
     compared: a 2-layer Qwen3-MoE at the real per-expert geometry (hidden
     2048, expert width 768, 32/4 heads, 8 experts, top-2) under
     W4A8_INT8KV_CFG and under INT4_BLOCKWISE_WEIGHT_ONLY_CFG, a 2-layer
     DeepSeek-V2 at the real attention and expert widths (hidden 2048, 16
     heads, r=512, dr=64, expert width 1408, 2 shared, 8 experts, top-2)
     under W4A8_INT8KV_CFG with an int8 latent cache, and a 2-layer llama;
     the llama and the DeepSeek-V2 again over paged caches (64-row pages
     scattered over the pool); the llama under FP8_DEFAULT_CFG (activation
     amax calibrated on the CPU) and the Qwen3-MoE under
     NVFP4_WEIGHT_ONLY_CFG, both with a bf16 cache; the DeepSeek-V2 under
     INT4_BLOCKWISE_WEIGHT_ONLY_CFG and NVFP4_WEIGHT_ONLY_CFG with a bf16
     latent cache (K10's straddle tiles, K13's tail); the llama under
     FP8_KV_CFG with an e4m3 KV cache, dense and paged; the DeepSeek-V2
     under FP8_KV_CFG with an e4m3 latent cache, dense and paged; an f32
     llama with skip-softmax (64-row blocks, int8 KV; again with no
     quantizer over an e4m3 KV cache) through cached prefill and
     greedy decode, tokens and every block selection equal; and
     tiny_test_config() (D = 16) over a bf16 dense cache, a prefill and
     one decode step, which the dense-cache gates send to K3 and the
     einsum on both devices; a tiny f32 llama quantized by the port on
     both devices from the same weights and ids under INT8_KV_CFG
     (SmoothQuant), W4A8_INT8KV_CFG (awq_lite) and NVFP4_SVDQUANT_CFG
     (SVDQuant on weights with a planted rank-32 part: each layer's
     low-rank product and residual, cuSOLVER against LAPACK): the same
     exponents, pre-quant scales within 1e-5, every fake-quant call of the
     CPU run (NVFP4 activations among them) repeated on the card bit for
     bit, compressed logits at the 3% bar; then K11's
     entry point, the compressed gateless QuantEinsum down projection at
     Qwen3-30B-A3B's expert geometry: K11 once a call and no other kernel,
     the card's result the CPU twin's bit for bit;
  4. serving paths, one after the other (each model freed before the next
     is built), each on random weights from a seed, served by ServingEngine
     (max_batch 8, max_seq_len 2176, prefill buckets (32, 544), multi_step
     16, max_admit 1): one warm-up request, then 8 requests x 1024 random
     prompt tokens -> 64 new tokens each, greedy. Launch counters are zeroed
     just before each measured run and read just after: every kernel of the
     path must have launched, and no kernel of another path (K11 on none);
     the KV write once a layer (K16 a forward on E, F, L; K3 a forward on D,
     a prefill chunk on the other dense paths, a forward on J);
     every cache tensor must be of the path's KV dtype;
       B: Qwen3-30B-A3B (full width, 4 of its 48 layers, PATH_LAYERS, so
          that the script keeps well inside its limit) under
          W4A8_INT8KV_CFG, KV scales calibrated by one 64-token forward;
       C: Qwen3-30B-A3B (full width, 4 of 48 layers) under
          INT4_BLOCKWISE_WEIGHT_ONLY_CFG (W4A16), bf16 KV cache;
       A: Llama-3-8B (full width and depth) under W4A8_INT8KV_CFG;
       D: DeepSeek-V2-Lite (full width: MLA, 64 experts top-6 plus 2
          shared, a dense first layer; 4 of its 27 layers) under
          W4A8_INT8KV_CFG, the int8 latent cache calibrated by one 64-token
          forward;
       E: A's model (16 of its 32 layers) over a paged KV cache: int8 pools of 145 pages of 64
          rows per layer (8 requests' worst case of 18 pages each, plus the
          null page; 53% of the dense cache);
       F: D's model over a paged int8 latent pool of 145 pages;
       G: A's model, 8 of its 32 layers (as H, K and L), under
          FP8_DEFAULT_CFG (e4m3 weights, static e4m3 activations
          calibrated by one 64-token forward), bf16 KV cache;
       H: A's model under INT8_WEIGHT_ONLY_CFG, bf16 KV cache;
       I: B's model (4 of 48 layers) under NVFP4_WEIGHT_ONLY_CFG, bf16 KV
          cache;
       K: A's model under FP8_KV_CFG (G's static e4m3 activations, and the
          k / v quantizers calibrated by the same 64-token forward) with an
          e4m3 KV cache;
       L: K over paged e4m3 pools of 145 pages;
       N: D's model under FP8_KV_CFG (e4m3 weights, static e4m3
          activations calibrated by one 64-token forward, the k quantizer's
          e4m3 latent codes; the MoE experts' e4m3 weights and the dense
          layer's K = 10944 down projection take the reference's dequantize
          route) with an e4m3 latent cache: K5's e4m3 latent cluster;
       O: N over paged e4m3 latent pools of 145 pages: K15's;
       M: Llama-3-8B (full width, 16 of 32 layers) built in bf16 on the card with
          channel outliers, quantized there under INT8_KV_CFG by its own
          algorithm (SmoothQuant on 4 x 512 captured tokens, then max
          calibration), held against its fake-quant self layer by layer
          and at the logits, compressed (the bf16 kernels dropped), then
          served: the 544-row prefill chunks through int8_dynamic_gemm,
          the 32-row bucket and decode through K7, K2-K4 over the int8
          KV cache;
       Q: D's model under INT4_BLOCKWISE_WEIGHT_ONLY_CFG with a bf16 latent
          cache: K6, K10 at straddle K (the experts' K = 1408; the dense
          layer's K = 10944 stays uncompressed, as in the reference), K3,
          the einsum's attention;
       R: D's model under NVFP4_WEIGHT_ONLY_CFG with a bf16 latent cache:
          K9, K13 with its 64-row tail, K3; the dense layer's K = 10944
          down projection takes the reference's dequantize route, counted
          once a forward;
       S: Llama-3-8B (full width, 8 of 32 layers) built in bf16 on the card
          with channel outliers, quantized there under NVFP4_SVDQUANT_CFG by
          its own algorithm (SVDQuant: smoothing, a rank-32 branch and the
          residual on every projection, each SVD timed, then max
          calibration; K14 in its forwards), held against its fake-quant
          self layer by layer (the SVD branch included) and at the logits,
          compressed, a census of one decode forward with and without the
          NVFP4 activation fake-quant, then served: K9 behind the
          fake-quantized NVFP4 activations at decode, the 544-row chunks
          through the reference's dequantize route (counted), K2-K4 over a
          bf16 KV cache;
     after each measured run, a torch.profiler window over decode ticks
     (device time by kernel, idle share) and one checked request; after
     A's and C's, a prefill window (one 1024-token prompt in the engine's
     chunks to its first token: wall, device time of K1 or K6, K3, K4 and
     the rest);
       J: A's model (8 of its 32 layers) and KV calibration, then at the Decoder level (no
          engine serves skip-softmax): calibrate_skip_softmax on RULER
          needle batches (K14 in its capture forwards), 8 prompts of 1024
          tokens prefilled in two chunks, 64 greedy decode steps through
          K17, with launch asserts and a profile window of 16 decode steps;
       P: J under FP8_KV_CFG with an e4m3 KV cache (K8, K14, K3, K17's e4m3
          branch);
  5. the PTQ phase: Llama-3-8B at full width, 4 of 32 layers, under
     W4A8_INT8KV_CFG (awq_lite), INT4_AWQ_FULL_CFG (awq_lite then
     awq_clip), NVFP4_AWQ_FULL_CFG (the same on NVFP4 weights, NVFP4
     activations) and NVFP4_KV_ROTATE_CFG (max calibration, q / k / v
     fake-quantized to NVFP4 in the Hadamard basis), each quantized,
     compressed and held against its fake-quant self as path M, its
     exponents and clip ratios logged, and one request served (K1, K6, K9
     and K2-K4), with launch asserts.
Then the int8_dynamic_gemm rows and one JSON line of per-kernel numbers
(launches by path, M and the PTQ phase among them), and last the device
line.
To iterate on one phase, import this module and call its phase function
(``kernel_phase``, ``flash_prefill_kernels``, ``flash_kernels``,
``parity_phase``, ``gateless_phase``, ``serve_path``, ``prefill_window``)
directly after ``_build.build_all()``; they print no contract line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s, bf16 flop/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
REPEATS = 25
# the shape each kernel's summary row reports (all shapes ride along)
PRIMARY = ("M=8 K=4096 N=28672",
           "B=8 S=2176 KH=8 G=4 D=128 int8 ragged pos",
           "M=8 K=2048 N=98304 bf16 out",
           "E=128 M=8 K=768 N=2048",  # K12 reports its first row (routed gscale)
           "E=128 M=8 K=768 N=2048 bf16 out",
           "B=8 S=2176 KH=1 G=16 D=640 int8 K=V lengths 1..1088",
           "B=8 PMAX=34 ps=64 KH=8 G=4 D=128 int8 ragged lengths",
           "rows B=8 T=1 row=1024 int8 K+V",  # K16's layer write at E's decode step
           "K+V B=1 T=544 S=2176 row=1024 int8 start=544",  # K3 at a prefill chunk
           "M=8 K=4096 N=28672 bf16 out",
           "B=8 S=2176 KH=8 G=4 D=128 block=128 NSEL=17 int8 lengths mid-block",
           "B=2 T=S=1024 KH=8 G=4 D=128 bf16 causal",
           "E=128 M=8 K=768 N=2048 no gates")

SOURCES = {
    "w4a8_gemm": ("modelopt_tpu_torch/csrc/w4a8_gemm.cu",
                  "modelopt_tpu/kernels/quant_gemm.py:425"),
    "dense_kv_write": ("modelopt_tpu_torch/csrc/kv_write.cu",
                       "modelopt_tpu/kernels/attention.py:342"),
    "fused_decode_attention": ("modelopt_tpu_torch/csrc/fused_decode_attention.cu",
                               "modelopt_tpu/kernels/attention.py:544"),
    "flash_prefill_attention": ("modelopt_tpu_torch/csrc/flash_prefill_attention.cu",
                                "modelopt_tpu/kernels/flash_attention.py:175"),
    "w4a16_gemm": ("modelopt_tpu_torch/csrc/w4a16_gemm.cu",
                   "modelopt_tpu/kernels/quant_gemm.py:181"),
    "grouped_w4a16_gemm": ("modelopt_tpu_torch/csrc/w4a16_gemm.cu",
                           "modelopt_tpu/kernels/quant_gemm.py:653"),
    "grouped_w4a8_combine_gemm": ("modelopt_tpu_torch/csrc/grouped_w4a8_gemm.cu",
                                  "modelopt_tpu/kernels/quant_gemm.py:773"),
    "decode_attention": ("modelopt_tpu_torch/csrc/decode_attention.cu",
                         "modelopt_tpu/kernels/attention.py:257"),
    "paged_decode_attention": ("modelopt_tpu_torch/csrc/decode_attention.cu",
                               "modelopt_tpu/kernels/paged_attention.py:65"),
    "paged_kv_write": ("modelopt_tpu_torch/csrc/paged_kv_write.cu",
                       "modelopt_tpu/kernels/paged_attention.py:126"),
    "w8a16_gemm": ("modelopt_tpu_torch/csrc/w8a16_gemm.cu",
                   "modelopt_tpu/kernels/quant_gemm.py:513"),
    "wfp8_gemm": ("modelopt_tpu_torch/csrc/w8a16_gemm.cu",
                  "modelopt_tpu/kernels/quant_gemm.py:548"),
    "nvfp4_gemm": ("modelopt_tpu_torch/csrc/nvfp4_gemm.cu",
                   "modelopt_tpu/kernels/quant_gemm.py:610"),
    "grouped_nvfp4_gemm": ("modelopt_tpu_torch/csrc/nvfp4_gemm.cu",
                           "modelopt_tpu/kernels/quant_gemm.py:843"),
    "block_sparse_decode_attention": ("modelopt_tpu_torch/csrc/decode_attention.cu",
                                      "modelopt_tpu/kernels/block_sparse_attention.py:61"),
    "flash_attention": ("modelopt_tpu_torch/csrc/flash_attention.cu",
                        "modelopt_tpu/kernels/flash_attention.py:108"),
    "grouped_w4a8_gemm": ("modelopt_tpu_torch/csrc/grouped_w4a8_gemm.cu",
                          "modelopt_tpu/kernels/quant_gemm.py:710"),
}
# wrappers that launch a kernel beside the one named after it, counted
# under its name
ENTRIES = {"dense_kv_write": ["dense_kv_write", "dense_kv_write_pair"],
           "paged_kv_write": ["paged_kv_write", "paged_kv_write_rows"]}
# kernels each serving path must launch
PATH_KERNELS = {
    "A": ("w4a8_gemm", "dense_kv_write", "fused_decode_attention",
          "flash_prefill_attention"),
    "B": ("w4a8_gemm", "dense_kv_write", "fused_decode_attention",
          "flash_prefill_attention", "grouped_w4a8_combine_gemm"),
    "C": ("w4a16_gemm", "grouped_w4a16_gemm", "dense_kv_write",
          "fused_decode_attention", "flash_prefill_attention"),
    "D": ("w4a8_gemm", "dense_kv_write", "decode_attention", "grouped_w4a8_combine_gemm"),
    "E": ("w4a8_gemm", "paged_kv_write", "paged_decode_attention"),
    "F": ("w4a8_gemm", "paged_kv_write", "paged_decode_attention",
          "grouped_w4a8_combine_gemm"),
    "G": ("wfp8_gemm", "dense_kv_write", "fused_decode_attention", "flash_prefill_attention"),
    "H": ("w8a16_gemm", "dense_kv_write", "fused_decode_attention", "flash_prefill_attention"),
    "I": ("nvfp4_gemm", "grouped_nvfp4_gemm", "dense_kv_write", "fused_decode_attention",
          "flash_prefill_attention"),
    "J": ("w4a8_gemm", "dense_kv_write", "flash_attention", "block_sparse_decode_attention"),
    "K": ("wfp8_gemm", "dense_kv_write", "fused_decode_attention", "flash_prefill_attention"),
    "L": ("wfp8_gemm", "paged_kv_write", "paged_decode_attention"),
    "M": ("w8a16_gemm", "dense_kv_write", "fused_decode_attention", "flash_prefill_attention"),
    # DeepSeek-V2-Lite under FP8_KV_CFG: the MoE experts' e4m3 weights take
    # the reference's dequantize-and-einsum route (no kernel), as does the
    # dense layer's down projection (K = 10944: not whole 128-row blocks)
    "N": ("wfp8_gemm", "dense_kv_write", "decode_attention"),
    "O": ("wfp8_gemm", "paged_kv_write", "paged_decode_attention"),
    "P": ("wfp8_gemm", "dense_kv_write", "flash_attention", "block_sparse_decode_attention"),
    # DeepSeek-V2-Lite under the weight-only presets over a bf16 latent cache
    # (attention through the einsum, as the reference's decode_attention_ok
    # admits int8 and e4m3 caches only): K6 and K10 at straddle K (the
    # experts' K = 1408; the dense layer's K = 10944 stays uncompressed, as
    # in the reference), K9 and K13 with the 64-row tail (the dense layer's
    # K = 10944 down projection takes the reference's dequantize route)
    "Q": ("w4a16_gemm", "grouped_w4a16_gemm", "dense_kv_write"),
    "R": ("nvfp4_gemm", "grouped_nvfp4_gemm", "dense_kv_write"),
    # Llama-3-8B under NVFP4_SVDQUANT_CFG, quantized on the card and served:
    # K9 behind the NVFP4 activation fake-quant at decode and in the 32-row
    # bucket (the 544-row chunks take the dequantize route, as the
    # reference's NVFP4 rule above 256 rows), K2-K4 over a bf16 cache
    "S": ("nvfp4_gemm", "dense_kv_write", "fused_decode_attention", "flash_prefill_attention"),
    # path S's quantize step, counted on its own: K14 in the capture and
    # calibration forwards, K9 in the per-layer checks of the packed model
    "S-quantize": ("nvfp4_gemm", "flash_attention"),
    # the PTQ phase: the capture and calibration forwards (K14 at 512
    # rows), then each compressed model's one request (K1 under W4A8 with
    # an int8 cache, K6 under INT4_AWQ_FULL_CFG with a bf16 one, K9 under
    # NVFP4_AWQ_FULL_CFG and NVFP4_KV_ROTATE_CFG)
    "PTQ": ("w4a8_gemm", "w4a16_gemm", "nvfp4_gemm", "dense_kv_write",
            "fused_decode_attention", "flash_prefill_attention", "flash_attention"),
    # the gateless-einsum phase: no served path reaches K11 (the MoE block
    # always passes gates, in the reference too)
    "gateless": ("grouped_w4a8_gemm",),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median device time of single launches, with the 50 MB L2 flushed
    before each (the main path meets its weights and caches cold). After the
    flush the stream spins for SPIN_CYCLES, so the card is still busy while
    the host enqueues the start event, the wrapper's launch and the end
    event: the wrapper's host time falls outside the measured interval. A
    plain version that synchronises inside (``.tolist()``, ``int(t)``) still
    counts its host time after the spin."""

    SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, repeats: int = REPEATS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def recorder(results: dict):
    """``record(name, shape, err, tol, ms, plain_ms, lib_ms, nbytes, ops,
    rate)``: one kernel row into ``results``, failing if ``err`` is above
    ``tol``; ``nbytes`` counts each input read once and each output written
    once."""
    def record(name, shape, err, tol, ms, plain_ms, lib_ms, nbytes, ops, rate):
        bound_b = nbytes / HBM_BPS * 1e3
        bound_o = ops / rate * 1e3
        row = {"shape": shape, "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(bound_b, bound_o),
               "bound_by": "bytes" if bound_b >= bound_o else "operations"}
        results.setdefault(name, []).append(row)
        log(f"  {name} {shape}: max_abs_err {err:.3g} (tol {tol:g}) | kernel "
            f"{ms:.4f} ms | plain {plain_ms:.4f} ms | library {lib_ms:.4f} ms | "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: error {err} above {tol}")
    return record


def kernel_phase(torch, results: dict) -> None:
    from modelopt_tpu_torch.kernels import attention as ka

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    record = recorder(results)

    moe_kernels(torch, gen, timer, record)
    fp_kernels(torch, gen, timer, record)

    w4a8_kernels(torch, gen, timer, record)
    w4a8_smem_agrees(torch)

    kv_write_kernels(torch, gen, timer, record)
    kv_pair_kernels(torch, gen, timer, record)

    # the e4m3 decode that K2 and K15 read caches through (csrc/e4m3.cuh),
    # on every code: the reference's bit assembly, 0x7f / 0xff -> +-480
    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    got, want = ka.e4m3_decode(codes), ka.e4m3_decode_plain(codes)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("e4m3 decode: the card's decode differs from the twin's")
    log(f"e4m3 decode: all 256 codes bit for bit against the twin (0x7f -> "
        f"{got[0x7F].item():g}, 0xff -> {got[0xFF].item():g}, 0x80 -> {got[0x80].item():g})")

    fused_decode_kernels(torch, gen, timer, record)
    flash_prefill_kernels(torch, gen, timer, record)
    latent_smem_agrees(torch)
    mla_decode_kernel(torch, gen, timer, record)
    paged_kernels(torch, gen, timer, record)
    paged_rows_kernels(torch, gen, timer, record)
    skip_softmax_kernels(torch, gen, timer, record)

    # the latent cluster kernel's e4m3 operand decode (csrc/e4m3.cuh's
    # e4m3_cache_pair) on every code: the reference's decode, bit for bit
    got = ka.e4m3_pair_decode(codes)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("e4m3 operand decode: the card's differs from the twin's")
    log(f"e4m3 operand decode of the latent cluster kernel: all 256 codes bit for bit "
        f"(0x7f -> {got[0x7F].item():g}, 0x01 -> {got[0x01].item():g})")
    e4m3_branch_kernels(torch, gen, timer, record)


def kv_write_kernels(torch, gen, timer, record) -> None:
    """K3 at a prefill chunk (T=544 rows of 1024 bytes into one slot, int8
    and e4m3) and at a decode step (B=8 slots, one row each at its own
    position, 1024 and 640 bytes): a copy, byte for byte."""
    from modelopt_tpu_torch.kernels import attention as ka

    dev = "cuda"
    # a copy: bit-exact
    log("K3 dense_kv_write")
    B, S, T, KHD, st = 1, 2176, 544, 1024, 544
    cache = torch.randint(-127, 128, (B, S, KHD), generator=gen, device=dev,
                          dtype=torch.int8)
    vals = torch.randint(-127, 128, (B, T, KHD), generator=gen, device=dev,
                         dtype=torch.int8)
    start = torch.full((B,), st, dtype=torch.int32, device=dev)
    got = ka.dense_kv_write(cache.clone(), vals, start)
    ref = ka.dense_kv_write_plain(cache.clone(), vals, start)
    err = (got.float() - ref.float()).abs().max().item()
    c2 = cache.clone()
    ms = timer(lambda: ka.dense_kv_write(c2, vals, start))
    plain_ms = timer(lambda: ka.dense_kv_write_plain(c2, vals, start))
    lib_ms = timer(lambda: c2[:, st:st + T].copy_(vals))
    record("dense_kv_write", f"B={B} T={T} S={S} row={KHD} int8 start={st}",
           err, 0.0, ms, plain_ms, lib_ms, 2 * B * T * KHD, 0, INT8_OPS)
    # the same copy of e4m3 rows (path K), byte for byte
    cache, vals = e4m3_codes(torch, gen, (B, S, KHD)), e4m3_codes(torch, gen, (B, T, KHD))
    got = ka.dense_kv_write(cache.clone(), vals, start)
    ref = ka.dense_kv_write_plain(cache.clone(), vals, start)
    c2 = cache.clone()
    ms = timer(lambda: ka.dense_kv_write(c2, vals, start))
    plain_ms = timer(lambda: ka.dense_kv_write_plain(c2, vals, start))
    lib_ms = timer(lambda: c2[:, st:st + T].copy_(vals))
    record("dense_kv_write", f"B={B} T={T} S={S} row={KHD} e4m3 start={st}",
           byte_diff(torch, got, ref), 0.0, ms, plain_ms, lib_ms, 2 * B * T * KHD, 0, INT8_OPS)
    one_launch(torch, f"dense_kv_write B={B} T={T} row={KHD}",
               lambda: ka.dense_kv_write(c2, vals, start))
    # a decode step's rows at B = 8 (path J's K and V rows, D's 640-byte
    # latent row), each slot's row at its own position, byte for byte; the
    # library call is the indexed write of one row a slot
    pos = torch.tensor([1023, 1500, 7, 2175, 300, 1024, 2000, 0], dtype=torch.int32, device=dev)
    slots, pos_l = torch.arange(8, device=dev), pos.long()
    for row in (1024, 640):
        cache = torch.randint(-127, 128, (8, S, row), generator=gen, device=dev, dtype=torch.int8)
        vals = torch.randint(-127, 128, (8, 1, row), generator=gen, device=dev, dtype=torch.int8)
        got = ka.dense_kv_write(cache.clone(), vals, pos)
        ref = ka.dense_kv_write_plain(cache.clone(), vals, pos)
        c2 = cache.clone()
        ms = timer(lambda: ka.dense_kv_write(c2, vals, pos))
        plain_ms = timer(lambda: ka.dense_kv_write_plain(c2, vals, pos))
        lib_ms = timer(lambda: c2.__setitem__((slots, pos_l), vals[:, 0]))
        # rows read and written once, the positions read once
        record("dense_kv_write", f"B=8 T=1 S={S} row={row} int8 own positions",
               byte_diff(torch, got, ref), 0.0, ms, plain_ms, lib_ms, 2 * 8 * row + 4 * 8, 0,
               INT8_OPS)
        one_launch(torch, f"dense_kv_write B=8 T=1 row={row}",
                   lambda: ka.dense_kv_write(c2, vals, pos))


def kv_pair_cases(torch, gen):
    """K3's two-cache form at an MHA layer's K and V caches [B, 2176, 1024]
    of int8 codes: (label, [k_cache, v_cache], [k_vals, v_vals], start) at a
    prefill chunk (B = 1, T = 544 from row 544) and at a decode step (B = 8,
    one row a slot at its own position, one past S - T: clamped)."""
    dev = "cuda"
    S, row = 2176, 1024
    for B, T, start in ((1, 544, [544]), (8, 1, [1023, 1500, 7, 2176, 300, 1024, 2000, 0])):
        caches = [torch.randint(-127, 128, (B, S, row), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2)]
        vals = [torch.randint(-127, 128, (B, T, row), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2)]
        yield (f"K+V B={B} T={T} S={S} row={row} int8 "
               + ("start=544" if T > 1 else "own positions"), caches, vals,
               torch.tensor(start, dtype=torch.int32, device=dev))


def kv_pair_kernels(torch, gen, timer, record) -> None:
    """K3's ``dense_kv_write_pair`` (an MHA layer's K and V in one launch)
    at ``kv_pair_cases``, byte for byte against its plain version, one
    device kernel a call; the library time is the reference's two one-cache
    writes as PyTorch calls (the indexed write of each cache's rows)."""
    from modelopt_tpu_torch.kernels import attention as ka

    log("K3 dense_kv_write_pair (K and V in one launch)")
    for label, caches, vals, start in kv_pair_cases(torch, gen):
        B, S, _ = caches[0].shape
        T = vals[0].shape[1]
        got = ka.dense_kv_write_pair(*[c.clone() for c in caches], *vals, start)
        ref = ka.dense_kv_write_pair_plain(*[c.clone() for c in caches], *vals, start)
        err = max(byte_diff(torch, g, r) for g, r in zip(got, ref))
        c2 = [c.clone() for c in caches]
        ms = timer(lambda: ka.dense_kv_write_pair(*c2, *vals, start))
        plain_ms = timer(lambda: ka.dense_kv_write_pair_plain(*c2, *vals, start))
        rows = start.long().clamp(0, S - T)[:, None] + torch.arange(T, device="cuda")
        slots = torch.arange(B, device="cuda")[:, None]
        lib_ms = timer(lambda: [c.__setitem__((slots, rows), v) for c, v in zip(c2, vals)])
        # both caches' rows read and written once, start read once
        record("dense_kv_write", label, err, 0.0, ms, plain_ms, lib_ms,
               2 * 2 * vals[0].numel() + 4 * B, 0, INT8_OPS)
        one_launch(torch, f"dense_kv_write_pair {label}",
                   lambda: ka.dense_kv_write_pair(*c2, *vals, start))
        del caches, c2


def w4a8_kernels(torch, gen, timer, record) -> None:
    """K1 at Llama-3-8B's four projections, at a decode step (M = 8, the
    mma.sync decode tile, its blocks split over a cluster of
    ``_w4a8_ranks`` CTAs) and a prefill chunk (M = 544, the wgmma tile),
    then at the prefill tile's edges with inputs of their own seed: M = 9,
    32, 64, 65, 130 and 300 (both tile heights, row tails) at DeepSeek-V2-Lite's
    kv_a_proj (K = 2048, N = 576: a 64-column tail of the 128-column tile),
    and the 32-row prefill bucket at 4096 x 28672; then, with inputs of a
    third seed, the decode tile at M = 8 on DeepSeek's kv_a_proj (the tail)
    and Qwen3-30B-A3B's decode shapes (K = 2048: N = 512, 4096, 98304;
    K = 4096: N = 2048), at M = 1 and 5 on 4096 x 4096, and one device
    kernel a call at M = 8 on 4096 x 4096 and 14336 x 4096 (the cluster's
    replay runs in the launch). Exact integer dots; the f32 block update
    repeats the plain version's rounding in block order, so f32 output is
    held bit for bit and the bf16 bar (M > 256) only absorbs the output's
    rounding."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant.qtensor import dequantize_int4, quantize_int4

    dev = "cuda"

    def row(xq, qt, wdq, K, N):
        M = xq.shape[0]
        out_dtype = torch.float32 if M <= 256 else torch.bfloat16
        y = kq.w4a8_gemm(xq, qt["data"], qt["scale"], out_dtype=out_dtype)
        ref = kq.w4a8_gemm_plain(xq, qt["data"], qt["scale"], 128, out_dtype)
        err = (y.float() - ref.float()).abs().max().item()
        tol = 0.0 if out_dtype == torch.float32 else ref.float().abs().max().item() * 2**-8
        xb = xq.to(torch.bfloat16)
        ms = timer(lambda: kq.w4a8_gemm(xq, qt["data"], qt["scale"], out_dtype=out_dtype))
        plain_ms = timer(lambda: kq.w4a8_gemm_plain(
            xq, qt["data"], qt["scale"], 128, out_dtype), 5)
        lib_ms = timer(lambda: torch.matmul(xb, wdq))
        nbytes = M * K + K * N // 2 + (K // 128) * N * 4 + \
            M * N * (4 if out_dtype == torch.float32 else 2)
        record("w4a8_gemm", f"M={M} K={K} N={N}", err, tol, ms, plain_ms,
               lib_ms, nbytes, 2 * M * K * N, INT8_OPS)

    def weights(g, K, N):
        qt = quantize_int4(torch.randn(K, N, generator=g, device=dev) * 0.02)
        return qt, dequantize_int4(qt).to(torch.bfloat16)

    def codes(g, M, K):
        return torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)

    log("K1 w4a8_gemm")
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        qt, wdq = weights(gen, K, N)
        for M in (8, 544):
            row(codes(gen, M, K), qt, wdq, K, N)
        del qt, wdq
    edge = torch.Generator(device=dev).manual_seed(1)
    qt, wdq = weights(edge, 2048, 576)
    for M in (9, 32, 64, 65, 130, 300):
        row(codes(edge, M, 2048), qt, wdq, 2048, 576)
    qt, wdq = weights(edge, 4096, 28672)
    row(codes(edge, 32, 4096), qt, wdq, 4096, 28672)
    del qt, wdq
    dec = torch.Generator(device=dev).manual_seed(2)
    for K, N, Ms in ((2048, 576, (8,)), (2048, 512, (8,)), (2048, 4096, (8,)),
                     (2048, 98304, (8,)), (4096, 2048, (8,)), (4096, 4096, (1, 5, 8)),
                     (14336, 4096, (8,))):
        qt, wdq = weights(dec, K, N)
        for M in Ms:
            xq = codes(dec, M, K)
            if (K, N, M) in ((4096, 4096, 8), (14336, 4096, 8)):  # timed with Llama's rows
                one_launch(torch, f"w4a8_gemm M={M} K={K} N={N}",
                           lambda: kq.w4a8_gemm(xq, qt["data"], qt["scale"]))
            else:
                row(xq, qt, wdq, K, N)
        del qt, wdq


def w4a8_smem_agrees(torch) -> None:
    """K1's decode-tile shared memory as the wrapper's rank picker counts it
    (``quant_gemm._w4a8_smem`` within ``SMEM_LIMIT``) against the kernel's
    own count (``w4a8_dec_smem``: ``dec::smem_bytes`` within ``MAX_SMEM``),
    for every cluster size the launch takes and every block count up to
    K = 65536: an R the picker chooses is one the launch accepts."""
    from modelopt_tpu_torch.kernels import _build
    from modelopt_tpu_torch.kernels import quant_gemm as kq

    fn = _build.function("w4a8_dec_smem", [_build.c_int] * 2, "w4a8_gemm")
    pairs = [(blocks, r) for blocks in range(1, 257) for r in (1, 2, 4, 8) if r <= blocks]
    for blocks, r in pairs:
        want = kq._w4a8_smem(blocks, r)
        want = want if want <= kq.SMEM_LIMIT else -1
        got = fn(blocks, r)
        if got != want:
            raise AssertionError(f"w4a8_gemm decode tile, {blocks} blocks, R={r}: the kernel "
                                 f"takes {got} bytes of shared memory, the picker counts {want}")
    log(f"K1 decode tile: the picker's shared memory equals the kernel's at {len(pairs)} "
        f"(blocks, R) pairs, 1-256 blocks")


def fused_decode_kernels(torch, gen, timer, record) -> None:
    """K2 at the dense paths' decode step: B = 8 slots at the engine's S =
    2176 (one chunk of keys) with ragged positions, Llama-3-8B's KH = 8, G =
    4 (int8, bf16 and e4m3 caches) and Qwen3-30B-A3B's KH = 4, G = 8 (int8,
    bf16); the same two geometries at the contexts the served paths' decode
    windows run (33-64 keys) and at ~512 keys. Then, with inputs of their
    own seed: S = 2048 (eight 256-key chunks, one round of the cluster) on
    int8 and bf16 caches with positions at chunk edges (255, 256), below the
    cluster size (0, 1, 7) and past the cache (clamped to S - 1); S = 4096
    bf16 at G = 8 (two rounds); long caches, where a CTA's shared memory
    must not grow with S: S = 16384 bf16 G = 8 (path C's geometry under a
    16k context, eight rounds) and S = 32768 int8 G = 8 (sixteen rounds);
    and S = 8320, one chunk of S, int8 G = 4, where a CTA's share of up to
    1040 keys passes the 512 keys it holds scores of and is scored twice.
    The caches must come out byte for byte as the plain version's.

    int8: integer dots are exact, so kernel and plain version differ only
    where exp() rounds a probability code e8 across .5. One flipped code
    moves an output by <= 254 * vs / sum(e8), and sum(e8) >= 127 on every
    live row; on these inputs the flips land on rows with large sums (0.0156
    measured on an H100), so the bar is vs = 0.03, half the one-flip bound
    of the smallest sum. bf16: f32 sums in another order and a few
    probabilities whose bf16 rounding goes the other way after a different
    exp() move an output by ~1e-4; then the output rounds to bf16, one ulp
    = 2^-9 below |out| 0.25. The bar 0.003 allows both (0.000488 measured
    on an H100); larger outputs must round alike. e4m3 (path K, G = 4): the
    bf16 arithmetic on exactly decoded codes, so the same two effects, held
    to 1e-3 plus one bf16 ulp of the largest output."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import attention as ka

    dev, B, D = "cuda", 8, 128

    def case(g, S, KH, G, kind, pos, q, tag):
        if kind == "e4m3":
            kc, vc = (e4m3_codes(torch, g, (B, S, KH * D)) for _ in range(2))
            kn, vn = (e4m3_codes(torch, g, (B, 1, KH * D)) for _ in range(2))
            ks = torch.tensor(0.02, device=dev)
            vs = torch.tensor(0.02, device=dev)
            tol = None  # set from the plain output below
            kd = (kc.float() * ks).to(torch.bfloat16)
            vd = (vc.float() * vs).to(torch.bfloat16)
            rate = BF16_FLOPS
        elif kind == "int8":
            kc, vc = (torch.randint(-127, 128, (B, S, KH * D), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            kn, vn = (torch.randint(-127, 128, (B, 1, KH * D), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            ks = torch.tensor(0.02, device=dev)
            vs = torch.tensor(0.03, device=dev)
            tol = 0.03
            kd = (kc.float() * ks).to(torch.bfloat16)
            vd = (vc.float() * vs).to(torch.bfloat16)
            rate = INT8_OPS
        else:
            kc, vc = (torch.randn(B, S, KH * D, generator=g, device=dev).to(torch.bfloat16)
                      for _ in range(2))
            kn, vn = (torch.randn(B, 1, KH * D, generator=g, device=dev).to(torch.bfloat16)
                      for _ in range(2))
            ks = vs = None
            tol = 0.003
            kd, vd = kc, vc
            rate = BF16_FLOPS
        out, kc1, vc1 = ka.fused_decode_attention(q, kn, vn, kc.clone(), vc.clone(), pos, ks, vs)
        ref, kc2, vc2 = ka.fused_decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pos,
                                                        ks, vs)
        err = (out.float() - ref.float()).abs().max().item()
        if tol is None:
            tol = 1e-3 + _ulp_bf16(ref.float().abs().max().item())
        if byte_diff(torch, kc1, kc2) or byte_diff(torch, vc1, vc2):
            raise AssertionError(f"fused_decode_attention {kind} S={S}: caches differ")
        kt, vt = kc.clone(), vc.clone()
        ms = timer(lambda: ka.fused_decode_attention(q, kn, vn, kt, vt, pos, ks, vs))
        plain_ms = timer(lambda: ka.fused_decode_attention_plain(
            q, kn, vn, kt, vt, pos, ks, vs), 5)
        L = pos.long().clamp(max=S - 1)
        qs = q.reshape(B, KH * G, 1, D)
        k4 = kd.reshape(B, S, KH, D).transpose(1, 2)
        v4 = vd.reshape(B, S, KH, D).transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :] <= L[:, None])[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qs, k4, v4, attn_mask=mask, enable_gqa=True))
        live = int((L + 1).sum())
        nbytes = 2 * live * KH * D * kc.element_size() + q.numel() * 2 + B * KH * G * D * 2
        record("fused_decode_attention", f"B={B} S={S} KH={KH} G={G} D={D} {kind} {tag}",
               err, tol, ms, plain_ms, lib_ms, nbytes, 4 * live * KH * G * D, rate)

    log("K2 fused_decode_attention")
    pos = torch.tensor([1023, 1500, 7, 2175, 300, 1024, 2000, 0], dtype=torch.int32, device=dev)
    for KH, G in ((8, 4), (4, 8)):  # Llama-3-8B, Qwen3-30B-A3B
        q = torch.randn(B, KH, G, D, generator=gen, device=dev).to(torch.bfloat16)
        for kind in ("int8", "bf16", "e4m3") if G == 4 else ("int8", "bf16"):
            case(gen, 2176, KH, G, kind, pos, q, "ragged pos")
    # the contexts of the served paths' decode windows, and a mid context
    ctx = torch.Generator(device=dev).manual_seed(3)
    for tag, pos in (("short context", [40, 64, 33, 56, 48, 60, 36, 52]),
                     ("mid context", [512, 480, 400, 505, 450, 500, 420, 470])):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        for KH, G, kind in ((8, 4, "int8"), (4, 8, "bf16")):
            q = torch.randn(B, KH, G, D, generator=ctx, device=dev).to(torch.bfloat16)
            case(ctx, 2176, KH, G, kind, pos, q, tag)
    edge = torch.Generator(device=dev).manual_seed(2)
    pos = torch.tensor([0, 1, 7, 255, 256, 1023, 2040, 3000], dtype=torch.int32, device=dev)
    q = torch.randn(B, 8, 4, D, generator=edge, device=dev).to(torch.bfloat16)
    for kind in ("int8", "bf16"):
        case(edge, 2048, 8, 4, kind, pos, q, "256-key chunks, edge pos")
    for S, KH, G, kind, pos, tag in (
            (4096, 4, 8, "bf16", [4095, 3000, 2048, 1024, 511, 100, 5, 0], "two rounds"),
            (16384, 4, 8, "bf16", [16383, 12000, 9000, 4096, 2048, 300, 5, 16500],
             "long cache, eight rounds"),
            (32768, 4, 8, "int8", [32767, 30000, 20000, 16384, 8191, 1000, 7, 0],
             "long cache, sixteen rounds"),
            (8320, 8, 4, "int8", [8319, 8000, 5000, 4100, 2049, 600, 1, 0],
             "one chunk of S, shares scored twice")):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = torch.randn(B, KH, G, D, generator=edge, device=dev).to(torch.bfloat16)
        case(edge, S, KH, G, kind, pos, q, tag)


def flash_prefill_kernels(torch, gen, timer, record) -> None:
    """K4 at the served paths' chunks: the second of a 1024-token prompt
    (T = 544 padded to its bucket, start 544) at both GQA groups on int8,
    bf16 and e4m3 caches; the first (start 0) and the unpadded second (T =
    480, start 544) on int8; a ragged row count (T = 481, G = 8: 3848 rows,
    not a multiple of the 64-row tile) on bf16."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import flash_attention as kf

    dev = "cuda"
    # K4 — online softmax vs one pass: the kernel rounds unnormalised
    # probabilities to bf16, the plain version normalised ones, each within
    # 2^-8 relative. Were every rounding maximal and of one sign on both
    # sides, the f32 outputs would differ by 2 * 2^-8 * max|v| (max|v| =
    # 127 * vs for int8 codes, the largest value of a bf16 cache); hundreds
    # of independent roundings per row leave far less, so the bar takes half
    # of that, 2^-8 * max|v|. Rounding the outputs to bf16 adds one ulp,
    # <= 2^-7 * max|ref| (0.0078 measured on an H100).
    # e4m3 codes (path K) dequantize to bf16 as int8 codes do: the same bar.
    log("K4 flash_prefill_attention")
    B, S, D = 1, 2176, 128
    bf16, f32 = torch.bfloat16, torch.float32
    cases = ((8, 4, "int8", 544, 544, bf16), (4, 8, "int8", 544, 544, bf16),
             (4, 8, "bf16", 544, 544, bf16), (8, 4, "e4m3", 544, 544, bf16),
             (8, 4, "int8", 544, 0, bf16), (8, 4, "int8", 480, 544, bf16),
             (4, 8, "bf16", 481, 544, bf16), (8, 4, "int8", 480, 544, f32))
    # the cases from the fifth on draw from a generator of their own, so the
    # first four (and every later phase) keep the inputs they had before
    # those cases were added
    gen_new = torch.Generator(device=dev).manual_seed(9)
    for i, (KH, G, kind, T, st, odt) in enumerate(cases):
        if i == 4:
            gen = gen_new
        q = torch.randn(B, T, KH, G, D, generator=gen, device=dev).to(torch.bfloat16)
        if kind == "e4m3":
            ck, cv = (e4m3_codes(torch, gen, (B, S, KH * D)) for _ in range(2))
            ks = torch.tensor(0.02, device=dev)
            vs = torch.tensor(0.02, device=dev)
            kd = (ck.float() * ks).to(torch.bfloat16)
            vd = (cv.float() * vs).to(torch.bfloat16)
            vmax = vd.float().abs().max().item()
        elif kind == "int8":
            ck = torch.randint(-127, 128, (B, S, KH * D), generator=gen, device=dev,
                               dtype=torch.int8)
            cv = torch.randint(-127, 128, (B, S, KH * D), generator=gen, device=dev,
                               dtype=torch.int8)
            ks = torch.tensor(0.02, device=dev)
            vs = torch.tensor(0.03, device=dev)
            vmax = 127 * 0.03
            kd = (ck.float() * ks).to(torch.bfloat16)
            vd = (cv.float() * vs).to(torch.bfloat16)
        else:
            ck = torch.randn(B, S, KH * D, generator=gen, device=dev).to(torch.bfloat16)
            cv = torch.randn(B, S, KH * D, generator=gen, device=dev).to(torch.bfloat16)
            ks = vs = None
            vmax = cv.float().abs().max().item()
            kd, vd = ck, cv
        start = torch.full((B,), st, dtype=torch.int32, device=dev)
        out = kf.flash_prefill_attention(q, ck, cv, start, ks, vs, odt)
        ref = kf.flash_prefill_attention_plain(q, ck, cv, start, ks, vs, odt)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2**-8 * vmax + (2**-7 * ref.float().abs().max().item() if odt == bf16 else 0.0)
        ms = timer(lambda: kf.flash_prefill_attention(q, ck, cv, start, ks, vs, odt))
        plain_ms = timer(lambda: kf.flash_prefill_attention_plain(
            q, ck, cv, start, ks, vs, odt), 5)
        qs = q.reshape(B, T, KH * G, D).transpose(1, 2)
        k4 = kd.reshape(B, S, KH, D).transpose(1, 2)
        v4 = vd.reshape(B, S, KH, D).transpose(1, 2)
        mask = torch.arange(S, device=dev)[None, :] <= (st + torch.arange(T, device=dev))[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qs, k4, v4, attn_mask=mask, enable_gqa=True))
        keys = sum(st + t + 1 for t in range(T))
        nbytes = q.numel() * 2 + out.numel() * out.element_size() + \
            2 * B * (st + T) * KH * D * ck.element_size()
        record("flash_prefill_attention",
               f"B={B} T={T} S={S} KH={KH} G={G} D={D} {kind} start={st}"
               + (" f32 out" if odt == f32 else ""),
               err, tol, ms, plain_ms, lib_ms, nbytes,
               4 * B * keys * KH * G * D, BF16_FLOPS)


def latent_smem_agrees(torch) -> None:
    """The latent cluster kernel's dynamic shared memory as
    ``attention.latent_smem`` counts it against the kernel's own count
    (``latent_decode_smem``) at every D it takes, for its int8 and its e4m3
    instance."""
    from modelopt_tpu_torch.kernels import _build
    from modelopt_tpu_torch.kernels import attention as ka

    fn = _build.function("latent_decode_smem", [_build.c_int] * 2, source="decode_attention")
    for dtype, kind in ((torch.int8, "int8"), (torch.float8_e4m3fn, "e4m3")):
        counts = {D: (fn(D, ka.CACHE_KIND[dtype]), ka.latent_smem(D, dtype))
                  for D in range(128, 641, 128)}
        if any(a != b for a, b in counts.values()):
            raise AssertionError(f"latent cluster kernel's {kind} shared memory: kernel / "
                                 f"Python {counts}")
        log(f"latent cluster kernel's {kind} shared memory, kernel = Python: "
            f"{ {D: a for D, (a, _) in counts.items()} } bytes")


def same_as_one_cta(torch, what: str, out, one, bar: float = 0.0) -> None:
    """The latent cluster kernel's output against the one-CTA body's on the
    same inputs (the body runs where V is a second buffer holding K's
    codes). int8 (``bar`` 0): bit for bit, the same codes, exact integer
    partials, the same f32 recurrence. e4m3: the same bf16 probabilities
    but where an f32 sum in another order moves one across a rounding
    point, and f32 sums in another order: within ``bar``."""
    if bar:
        err = (out.float() - one.float()).abs().max().item()
        log(f"  {what}: the latent cluster kernel against the one-CTA body: max |diff| "
            f"{err:.3g} (bar {bar:.3g})")
        if not err <= bar:
            raise AssertionError(f"{what}: the latent cluster kernel differs from the one-CTA "
                                 f"body by {err} > {bar}")
        return
    if not torch.equal(out.view(torch.int16), one.view(torch.int16)):
        raise AssertionError(f"{what}: the latent cluster kernel differs from the one-CTA body "
                             f"by {(out.float() - one.float()).abs().max().item():g}")
    log(f"  {what}: the latent cluster kernel = the one-CTA body, bit for bit")


def mla_decode_kernel(torch, gen, timer, record) -> None:
    """K5 at the MLA decode shape of DeepSeek-V2-Lite: B=8 slots, one
    shared KV head, G=16 query heads, D=640 (the 576-wide latent row
    padded), the same int8 latent tensor as K and V, lengths spread over
    1..1088; S=2176 is one chunk of S (2176 % 256 != 0), S=512 two chunks,
    where the 7-bit codes are rounded against a running max; lengths
    33..56 (D's decode-window contexts: one piece a slot, rank 0 of each
    cluster alone); then a bf16 cache at the path shape. The int8 rows run
    the latent cluster kernel and are also held to the one-CTA body."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import attention as ka

    dev = "cuda"
    # Kernel and plain version run the same exact integer dots and the same
    # f32 operations in the same order; they differ only where expf and
    # torch.exp round a probability code e8 across .5. One flipped code
    # moves an output by <= 254 * vs / sum(e8) <= 2 * vs (sum(e8) >= 127 on
    # a live row); the bar takes half of that, vs, as K2 does, plus one
    # bf16 ulp of the largest output for the final rounding.
    log("K5 decode_attention")
    B, G, D, vs_ = 8, 16, 640, 0.03
    short = torch.tensor([33, 40, 56, 50, 47, 36, 45, 52], dtype=torch.int32, device=dev)
    for S, top in ((2176, 1088), (512, 512), (2176, None)):
        q = (torch.randn(B, 1, G, D, generator=gen, device=dev) * 2).to(torch.bfloat16)
        lat = torch.randint(-127, 128, (B, S, D), generator=gen, device=dev,
                            dtype=torch.int8)
        lengths = (torch.linspace(1, top, B, device=dev).round().to(torch.int32)
                   if top else short)
        label = f"lengths 1..{top}" if top else "lengths 33..56"
        sc = torch.tensor(vs_, device=dev)
        out = ka.decode_attention(q, lat, lat, lengths, sc, sc)
        same_as_one_cta(torch, f"K5 S={S} {label}", out,
                        ka.decode_attention(q, lat, lat.clone(), lengths, sc, sc))
        one_launch(torch, f"decode_attention S={S} {label}",
                   lambda: ka.decode_attention(q, lat, lat, lengths, sc, sc))
        ref = ka.decode_attention_plain(q, lat, lat, lengths, sc, sc)
        err = (out.float() - ref.float()).abs().max().item()
        top_ref = ref.float().abs().max().item()
        tol = vs_ + 2.0 ** (math.floor(math.log2(top_ref)) - 7)
        ms = timer(lambda: ka.decode_attention(q, lat, lat, lengths, sc, sc))
        plain_ms = timer(lambda: ka.decode_attention_plain(q, lat, lat, lengths, sc, sc), 5)
        kv = (lat.float() * vs_).to(torch.bfloat16)[:, None]   # [B, 1, S, D]
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None].long())
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q.reshape(B, G, 1, D), kv, kv, attn_mask=mask[:, None, None, :], enable_gqa=True))
        live = int(lengths.long().sum())
        # the aliased K = V rows are read once; q in, out back, bf16
        nbytes = live * D + 2 * B * G * D * 2
        record("decode_attention", f"B={B} S={S} KH=1 G={G} D={D} int8 K=V {label}",
               err, tol, ms, plain_ms, lib_ms, nbytes, 4 * live * G * D, INT8_OPS)

    # A bf16 cache (off the served paths: MLA decodes a bf16 latent cache
    # with einsums, as the reference does) at the same shape. Kernel and
    # plain version sum in f32 in another order and may round a
    # probability to the other bf16 after a different exp(), ~1e-4 on an
    # output; a sum that differs in its last bits may then round to the
    # neighbouring bf16 output, one ulp of the largest output.
    S, top = 2176, 1088
    q = torch.randn(B, 1, G, D, generator=gen, device=dev).to(torch.bfloat16)
    lat = torch.randn(B, S, D, generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.linspace(1, top, B, device=dev).round().to(torch.int32)
    out = ka.decode_attention(q, lat, lat, lengths)
    ref = ka.decode_attention_plain(q, lat, lat, lengths)
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-3 + 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    ms = timer(lambda: ka.decode_attention(q, lat, lat, lengths))
    plain_ms = timer(lambda: ka.decode_attention_plain(q, lat, lat, lengths), 5)
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None].long())
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q.reshape(B, G, 1, D), lat[:, None], lat[:, None], attn_mask=mask[:, None, None, :],
        enable_gqa=True))
    live = int(lengths.long().sum())
    record("decode_attention", f"B={B} S={S} KH=1 G={G} D={D} bf16 K=V lengths 1..{top}",
           err, tol, ms, plain_ms, lib_ms, live * D * 2 + 2 * B * G * D * 2,
           4 * live * G * D, BF16_FLOPS)


PAGE_SIZE, PAGED_POOL = 64, 145  # paths E and F: 64-row pages, 145 a pool


def page_table(torch, lengths, pmax: int, n_pages: int, seed: int = 0):
    """An int32 page table [B, pmax] on the card giving each slot the pages
    its length needs, drawn without repeats from a shuffled pool (page 0,
    the null page, excluded); unused entries point at page 0."""
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    pt = torch.zeros(len(lengths), pmax, dtype=torch.int32)
    used = 0
    for b, L in enumerate(lengths):
        n = -(-int(L) // PAGE_SIZE)
        pt[b, :n] = perm[used:used + n]
        used += n
    return pt.to("cuda")


def paged_kernels(torch, gen, timer, record) -> None:
    """K15 at path E's decode shape (B=8 slots, KH=8, G=4, D=128, 64-row
    pages, PMAX=34, ragged lengths up to the whole table) on int8 pools and
    on bf16 pools (off the paths), and at path F's (KH=1, G=16, D=640, one
    int8 latent pool as K and V, lengths 1..1088); every pool of 145 pages
    holds random codes, the null page too (a read of it would show). K16 at
    a prefill chunk (T=544 tokens of E's 1024-byte rows) and at E's and F's
    decode steps (8 slots, one row each, distinct targets)."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import paged_attention as kp

    dev = "cuda"
    ps, pmax, P = PAGE_SIZE, 2176 // PAGE_SIZE, PAGED_POOL
    # K15: as K5 (the same kernel body), kernel and plain version differ only
    # where expf and torch.exp round a 7-bit code across .5: an int8 bar of
    # vs plus one bf16 ulp of the largest output; bf16 and e4m3 pools (path
    # L), f32 sums in another order, 1e-3 plus one output ulp.
    log("K15 paged_decode_attention")
    lengths_e = torch.tensor([1024, 1501, 8, 2176, 301, 1025, 2001, 1], dtype=torch.int32,
                             device=dev)
    lengths_f = torch.linspace(1, 1088, 8, device=dev).round().to(torch.int32)
    # E's geometry also at one page a slot (33-64 keys) and over a 128-page
    # table (8192 keys a slot: the cluster kernel's rounds of 64 pages)
    lengths_1 = torch.tensor([33, 40, 64, 50, 47, 63, 45, 64], dtype=torch.int32, device=dev)
    lengths_128 = torch.tensor([8192, 8000, 7000, 8192, 100, 4097, 8191, 6000],
                               dtype=torch.int32, device=dev)
    # F's geometry also at its decode-window contexts (33..56 keys: one
    # page a slot, rank 0 of each cluster alone); O is F over an e4m3
    # latent pool (the latent cluster kernel's e4m3 instance)
    lengths_fs = torch.tensor([33, 40, 56, 50, 47, 36, 45, 52], dtype=torch.int32, device=dev)
    cases = (("E", 8, 4, 128, "int8", lengths_e, pmax, P),
             ("E", 8, 4, 128, "bf16", lengths_e, pmax, P),
             ("F", 1, 16, 640, "int8", lengths_f, pmax, P),
             ("F1", 1, 16, 640, "int8", lengths_fs, pmax, P),
             ("O", 1, 16, 640, "e4m3", lengths_f, pmax, P),
             ("O1", 1, 16, 640, "e4m3", lengths_fs, pmax, P),
             ("L", 8, 4, 128, "e4m3", lengths_e, pmax, P),
             ("E1", 8, 4, 128, "int8", lengths_1, pmax, P),
             ("E128", 8, 4, 128, "int8", lengths_128, 128, 8 * 128 + 1))
    for path, KH, G, D, kind, lengths, tmax, pool in cases:
        B = lengths.shape[0]
        pt = page_table(torch, lengths.tolist(), tmax, pool)
        q = (torch.randn(B, KH, G, D, generator=gen, device=dev) * 2).to(torch.bfloat16)
        if kind == "e4m3":
            pools = [e4m3_codes(torch, gen, (pool, ps, KH * D)) for _ in range(2 if KH > 1 else 1)]
            ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.02, device=dev)
            deq = [(p.float() * s).to(torch.bfloat16) for p, s in zip(pools, (ks, vs))]
            rate = BF16_FLOPS
        elif kind == "int8":
            pools = [torch.randint(-127, 128, (pool, ps, KH * D), generator=gen, device=dev,
                                   dtype=torch.int8) for _ in range(2 if KH > 1 else 1)]
            ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.03, device=dev)
            if KH == 1:  # MLA: one latent tensor and scale as K and V
                ks = vs
            deq = [(p.float() * s).to(torch.bfloat16) for p, s in zip(pools, (ks, vs))]
            rate = INT8_OPS
        else:
            pools = [torch.randn(pool, ps, KH * D, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2)]
            ks = vs = None
            deq = pools
            rate = BF16_FLOPS
        kpool, vpool = pools[0], pools[-1]
        out = kp.paged_decode_attention(q, kpool, vpool, pt, lengths, ks, vs)
        ref = kp.paged_decode_attention_plain(q, kpool, vpool, pt, lengths, ks, vs)
        err = (out.float() - ref.float()).abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
        tol = (0.03 if kind == "int8" else 1e-3) + ulp
        if path[0] in "FO":  # the latent cluster kernel
            same_as_one_cta(torch, f"K15 {path} PMAX={tmax}", out, kp.paged_decode_attention(
                q, kpool, kpool.clone(), pt, lengths, ks, vs), 0.0 if kind == "int8" else tol)
            one_launch(torch, f"paged_decode_attention {path}",
                       lambda: kp.paged_decode_attention(q, kpool, vpool, pt, lengths, ks, vs))
        ms = timer(lambda: kp.paged_decode_attention(q, kpool, vpool, pt, lengths, ks, vs))
        plain_ms = timer(lambda: kp.paged_decode_attention_plain(q, kpool, vpool, pt, lengths,
                                                                 ks, vs), 5)
        S = tmax * ps
        k4 = kp.paged_gather_dense(deq[0], pt).reshape(B, S, KH, D).transpose(1, 2)
        v4 = kp.paged_gather_dense(deq[-1], pt).reshape(B, S, KH, D).transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None].long())
        qs = q.reshape(B, KH * G, 1, D)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qs, k4, v4, attn_mask=mask[:, None, None, :], enable_gqa=True))
        del k4, v4
        live = int(lengths.long().sum())
        item = kpool.element_size()
        # live rows once each (K and V, or the one latent pool), the live
        # table entries, lengths, q in and out back in bf16
        nbytes = (len(pools) * live * KH * D * item + 4 * sum(-(-int(L) // ps) for L in
                  lengths.tolist()) + 4 * B + 2 * 2 * B * KH * G * D)
        shape = (f"B={B} PMAX={tmax} ps={ps} KH={KH} G={G} D={D} {kind} "
                 + {"F": "K=V lengths 1..1088", "F1": "K=V lengths 33..56",
                    "O": "K=V lengths 1..1088", "O1": "K=V lengths 33..56",
                    "E1": "one page a slot"}.get(path, "ragged lengths"))
        record("paged_decode_attention", shape, err, tol, ms, plain_ms, lib_ms, nbytes,
               4 * live * KH * G * D, rate)
        del pools, deq, kpool, vpool

    # K16: a copy, bit-exact; the decode cases aim every slot at its own row
    log("K16 paged_kv_write")
    for B, T, row, start, kind in ((1, 544, 1024, 544, "int8"), (8, 1, 1024, None, "int8"),
                                   (8, 1, 640, None, "int8"), (8, 1, 1024, None, "e4m3")):
        if kind == "e4m3":  # path L's decode step
            pool = e4m3_codes(torch, gen, (P, ps, row))
            vals = e4m3_codes(torch, gen, (B, T, row))
        else:
            pool = torch.randint(-127, 128, (P, ps, row), generator=gen, device=dev,
                                 dtype=torch.int8)
            vals = torch.randint(-127, 128, (B, T, row), generator=gen, device=dev,
                                 dtype=torch.int8)
        if T > 1:  # a prefill chunk at rows [start, start + T) of one slot
            pos = torch.arange(start, start + T, device=dev, dtype=torch.int32)[None]
            pt = page_table(torch, [start + T], pmax, P)
            pids = pt.gather(1, (pos // ps).long())
            offs = pos % ps
        else:  # one row per slot, slots on distinct pages
            pids = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))[:B] + 1)
            pids = pids.to(dev, torch.int32)[:, None]
            offs = torch.randint(0, ps, (B, 1), generator=gen, device=dev, dtype=torch.int32)
        pids, offs = pids.contiguous(), offs.contiguous()
        got = kp.paged_kv_write(pool.clone(), vals, pids, offs)
        ref = kp.paged_kv_write_plain(pool.clone(), vals, pids, offs)
        err = byte_diff(torch, got, ref)
        p2 = pool.clone()
        ms = timer(lambda: kp.paged_kv_write(p2, vals, pids, offs))
        plain_ms = timer(lambda: kp.paged_kv_write_plain(p2, vals, pids, offs))
        li, lo = pids.long(), offs.long()
        lib_ms = timer(lambda: p2.index_put_((li, lo), vals))
        # rows read and written once, pids and offs read once
        record("paged_kv_write", f"B={B} T={T} row={row} {kind}", err, 0.0, ms, plain_ms,
               lib_ms, 2 * B * T * row + 8 * B * T, 0, INT8_OPS)
        del pool, p2


def paged_rows_cases(torch, gen):
    """K16's layer-write cases over pools of PAGED_POOL pages of 64 rows and
    a 34-column table: (label, pools, rows, page_table, positions, drops)
    with ``drops`` true where a target lies outside the pool. E's decode
    step (two int8 pools of 1024-byte rows, 8 slots, one row each at its
    slot's last position), E's prefill chunk (B = 1, T = 544 from row 544),
    F's decode step (one int8 latent pool, 576-byte rows padded to 640), L's
    (two e4m3 pools); E's geometry with one slot past the table's capacity
    and four idle slots on the null page, three of them aimed at one row
    with equal values; F's with two slots' pages outside the pool."""
    dev = "cuda"
    ps, pmax, P = PAGE_SIZE, 2176 // PAGE_SIZE, PAGED_POOL
    ends = [1024, 1501, 8, 2176, 301, 1025, 2001, 1]

    def codes(kind, shape):
        if kind == "e4m3":
            return e4m3_codes(torch, gen, shape)
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def case(label, kind, n_pools, w, lengths, positions, edit=None):
        pt = page_table(torch, lengths, pmax, P)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev).reshape(len(lengths), -1)
        row = 640 if w == 576 else w
        pools = [codes(kind, (P, ps, row)) for _ in range(n_pools)]
        rows = [codes(kind, (*pos.shape, w)) for _ in range(n_pools)]
        drops = False
        if edit is not None:
            drops = edit(pt, rows)
        return label, pools, rows, pt, pos, drops

    yield case("rows B=8 T=1 row=1024 int8 K+V", "int8", 2, 1024, ends,
               [e - 1 for e in ends])
    yield case("rows B=1 T=544 row=1024 int8 K+V start=544", "int8", 2, 1024, [1088],
               list(range(544, 1088)))
    yield case("rows B=8 T=1 row=576->640 int8 latent", "int8", 1, 576, ends,
               [e - 1 for e in ends])
    yield case("rows B=8 T=1 row=1024 e4m3 K+V", "e4m3", 2, 1024, ends, [e - 1 for e in ends])

    def idle_equal(pt, rows):  # slots 4-6 all write (page 0, row 5)
        for r in rows:
            r[5:7] = r[4]
        return False

    yield case("rows B=8 T=1 row=1024 int8 K+V past capacity, idle slots on page 0",
               "int8", 2, 1024, [1024, 2176, 8, 301, 0, 0, 0, 0],
               [1023, pmax * ps + 5, 7, 300, 5, 5, pmax * ps + 5, 9], idle_equal)

    def outside(pt, rows):  # slots 1 and 5: their current page is no pool page
        pt[1, 1500 // ps] = P
        pt[5, 1024 // ps] = P + 1000
        return True

    yield case("rows B=8 T=1 row=576->640 int8 latent, page ids outside the pool", "int8", 1,
               576, ends, [e - 1 for e in ends], outside)


def paged_rows_kernels(torch, gen, timer, record) -> None:
    """K16's ``paged_kv_write_rows`` (a paged layer's whole write: the page
    lookup, MLA's zero pad, every pool, one launch) at ``paged_rows_cases``,
    byte for byte against its plain version (which runs the reference's
    composite), one device kernel a call. The library time is the torch
    composite it replaces: ``page_slots``, the zero pad where the row is
    narrower than the pool's, and ``index_put_`` a pool (where targets lie
    outside the pool, the rows that land, as the plain version picks them)."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import paged_attention as kp

    log("K16 paged_kv_write_rows (one launch a layer)")
    for label, pools, rows, pt, pos, drops in paged_rows_cases(torch, gen):
        P, ps, row = pools[0].shape
        B, T = pos.shape
        got = kp.paged_kv_write_rows([p.clone() for p in pools], rows, pt, pos)
        ref = kp.paged_kv_write_rows_plain([p.clone() for p in pools], rows, pt, pos)
        err = max(byte_diff(torch, g, r) for g, r in zip(got, ref))
        p2 = [p.clone() for p in pools]
        ms = timer(lambda: kp.paged_kv_write_rows(p2, rows, pt, pos))
        plain_ms = timer(lambda: kp.paged_kv_write_rows_plain(p2, rows, pt, pos))

        def library():
            pids, offs = kp.page_slots(pt, pos, ps)
            li, lo = pids.long(), offs.long()
            for p, v in zip(p2, rows):
                if v.shape[-1] < row:
                    v = F.pad(v, (0, row - v.shape[-1]))
                if drops:
                    keep = li < P
                    p.index_put_((li[keep], lo[keep]), v[keep])
                else:
                    p.index_put_((li, lo), v)

        lib_ms = timer(library)
        # rows read once and pool rows written once a pool, positions and
        # the table entries the rows use read once
        col = (pos.long() // ps).clamp(max=pt.shape[1] - 1)
        entries = torch.unique(torch.arange(B, device="cuda")[:, None] * pt.shape[1]
                               + col).numel()
        item = pools[0].element_size()
        nbytes = len(pools) * B * T * (rows[0].shape[-1] + row) * item + 4 * B * T + 4 * entries
        record("paged_kv_write", label, err, 0.0, ms, plain_ms, lib_ms, nbytes, 0, INT8_OPS)
        one_launch(torch, f"paged_kv_write_rows {label}",
                   lambda: kp.paged_kv_write_rows(p2, rows, pt, pos))
        del pools, p2


def write_census(torch, strict: bool = True) -> dict:
    """What one paged decode forward puts on the card, and how much of it is
    the KV write: a 2-layer llama at path E's attention geometry (32 / 8
    heads of 128, hidden 1024) and a 2-layer MLA at DeepSeek-V2-Lite's
    latent row (r = 512, dr = 64: 576 of 640 lanes), unquantized, random
    weights, bf16 pools of 64-row pages; 8 slots prefilled 40 tokens, then
    two decode forwards, the second profiled (the first warms the profiler
    up). Returns {model: (host launch calls, device kernel records, K16
    launches in the two decode forwards)}. ``strict`` (this tree):
    ``page_slots`` and ``nn.functional.pad`` raise while the forwards run,
    so the paged writes call neither on the card, and K16 must launch once
    a layer a forward."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.kernels import paged_attention as kp
    from modelopt_tpu_torch.models import llama_config, small_mla_compressed_config
    from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
    from modelopt_tpu_torch.serve.paged_cache import (PagedCacheConfig, make_paged_cache,
                                                      write_page_table)

    def refuse(*a, **k):
        raise AssertionError("the paged write called page_slots or pad on the card")

    out = {}
    cfgs = {"llama E geometry": llama_config(
                vocab_size=1024, hidden_size=1024, num_layers=2, num_heads=32,
                num_kv_heads=8, head_dim=128, intermediate_size=2048,
                max_position_embeddings=128, fused_qkv=True, fused_gate_up=True),
            "MLA V2-Lite latent row": small_mla_compressed_config(
                kv_lora_rank=512, qk_rope_head_dim=64, max_position_embeddings=128)}
    for model, cfg in cfgs.items():
        bundle = build_compressed_bundle(cfg, {"quant_cfg": {}}, seed=0, device="cuda")
        cache = make_paged_cache(cfg, 8, PagedCacheConfig(page_size=PAGE_SIZE, n_pages=17,
                                                          max_pages_per_slot=2), device="cuda")
        for slot in range(8):
            write_page_table(cache, slot, [1 + 2 * slot, 2 + 2 * slot])
        ids = torch.randint(1, cfg.vocab_size, (8, 40), dtype=torch.int32, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
        patches = ((kp, "page_slots"), (F, "pad")) if strict else ()
        saved = [getattr(m, n) for m, n in patches]
        for m, n in patches:
            setattr(m, n, refuse)
        try:
            _, cache = bundle.apply(ids, cache)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for i in range(2):
                    _, cache = bundle.apply(ids[:, i:i + 1], cache)
                    torch.cuda.synchronize()
                    prof.step()
        finally:
            for (m, n), f in zip(patches, saved):
                setattr(m, n, f)
        k16 = kernels.launch_counts()["paged_kv_write"]
        events = prof.key_averages()
        calls = sum(ev.count for ev in events if ev.device_type == DeviceType.CPU
                    and any(k in ev.key for k in ("Launch", "Memcpy", "Memset")))
        records = sum(ev.count for ev in events if ev.device_type == DeviceType.CUDA
                      and not ev.key.startswith("ProfilerStep"))
        out[model] = (calls, records, k16)
        log(f"  census, {model}, {cfg.num_layers} layers, one paged decode forward: {calls} "
            f"host launch calls, {records} device kernel records; K16 {k16} launches in two "
            f"forwards")
        if strict and k16 != 2 * cfg.num_layers:
            raise AssertionError(f"census {model}: K16 launched {k16} times in two forwards "
                                 f"of {cfg.num_layers} layers, want one a layer")
        del bundle, cache
    torch.cuda.empty_cache()
    return out


def e4m3_codes(torch, gen, shape):
    """e4m3 cache codes on the card: N(0, 48^2) values clipped to +-448 and
    rounded, so no 0x7f / 0xff code (NaN under a float8 cast, +-480 under
    the reference's decode) is among them."""
    x = torch.randn(shape, generator=gen, device="cuda") * 48.0
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn)


def byte_diff(torch, a, b) -> float:
    """The largest difference of two tensors' bytes (0: bit for bit)."""
    return (a.view(torch.uint8).int() - b.view(torch.uint8).int()).abs().max().item()


def _ulp_bf16(x: float) -> float:
    """One bf16 ulp at the magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def skip_softmax_kernels(torch, gen, timer, record) -> None:
    """Path J's kernels: K17 (``block_sparse_kernels``), then K14
    (``flash_kernels``)."""
    block_sparse_kernels(torch, gen, timer, record)
    flash_kernels(torch, gen, timer, record)


def block_sparse_kernels(torch, gen, timer, record, kinds=("int8", "bf16")) -> None:
    """K17 at path J's decode shape (B=8 slots, KH=8, G=4, D=128, S=2176,
    128-row blocks, NSEL=17 table entries: the cluster kernel) on the caches
    of ``kinds`` (int8 and bf16; e4m3 as on path P), lengths in the middle
    of the 9th block, fewer live entries than in-range blocks in shuffled
    order (forced blocks first, as ``select_blocks`` orders them); then,
    with inputs of their own seed, short selections (every slot one block,
    every slot two) and the edge cases of the cluster's CPU model (a slot
    with no live entry, one whose first block lies wholly past its length
    before a live block, one whose every block is masked), each on every
    kind; and one device kernel a call at J's shape, int8 and e4m3."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import block_sparse_attention as kb

    dev = "cuda"
    # K17: as K5 and K15 (the same arithmetic), kernel and plain version
    # differ only where expf and torch.exp round a 7-bit code across .5:
    # an int8 bar of vs plus one bf16 ulp of the largest output; bf16 and
    # e4m3 caches, f32 sums in another order, 1e-3 plus one output ulp.
    log("K17 block_sparse_decode_attention")
    B, KH, G, D, S, bs, nsel = 8, 8, 4, 128, 2176, 128, 17

    def case(g, lengths, nvalid, sel, label):
        q = (torch.randn(B, KH, G, D, generator=g, device=dev) * 2).to(torch.bfloat16)
        for kind in kinds:
            if kind == "int8":
                kc, vc = (torch.randint(-127, 128, (B, S, KH * D), generator=g, device=dev,
                                        dtype=torch.int8) for _ in range(2))
                ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.03, device=dev)
                kd, vd = ((c.float() * sc).to(torch.bfloat16) for c, sc in ((kc, ks), (vc, vs)))
                rate = INT8_OPS
            elif kind == "e4m3":
                kc, vc = (e4m3_codes(torch, g, (B, S, KH * D)) for _ in range(2))
                ks, vs = torch.tensor(0.02, device=dev), torch.tensor(0.02, device=dev)
                kd, vd = ((c.float() * sc).to(torch.bfloat16) for c, sc in ((kc, ks), (vc, vs)))
                rate = BF16_FLOPS
            else:
                kc, vc = (torch.randn(B, S, KH * D, generator=g, device=dev).to(torch.bfloat16)
                          for _ in range(2))
                ks = vs = None
                kd, vd = kc, vc
                rate = BF16_FLOPS
            args = (q, kc, vc, sel, nvalid, lengths, ks, vs)
            out = kb.block_sparse_decode_attention(*args, block_size=bs)
            ref = kb.block_sparse_decode_attention_plain(*args, block_size=bs)
            err = (out.float() - ref.float()).abs().max().item()
            tol = (0.03 if kind == "int8" else 1e-3) + _ulp_bf16(ref.float().abs().max().item())
            ms = timer(lambda: kb.block_sparse_decode_attention(*args, block_size=bs))
            plain_ms = timer(lambda: kb.block_sparse_decode_attention_plain(*args, block_size=bs),
                             5)
            # the library call: SDPA over the live blocks, gathered and
            # dequantized beforehand, dead entries and keys past the length masked
            k4 = kb._gather_blocks(kd, sel, bs).reshape(B, nsel * bs, KH, D).transpose(1, 2)
            v4 = kb._gather_blocks(vd, sel, bs).reshape(B, nsel * bs, KH, D).transpose(1, 2)
            pos = (sel.long()[..., None] * bs + torch.arange(bs, device=dev)).reshape(B, -1)
            live = (torch.arange(nsel, device=dev)[None, :, None] < nvalid.long()[:, None, None])
            mask = (pos < lengths.long()[:, None]) & live.expand(B, nsel, bs).reshape(B, -1)
            qs = q.reshape(B, KH * G, 1, D)
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, k4, v4, attn_mask=mask[:, None, None, :], enable_gqa=True))
            del k4, v4
            # the K and V rows of the live keys once each, and the V rows of
            # the selected blocks of a slot with no live key (its output is
            # their mean; every score is -1e30, so its K rows are not
            # needed); the table, nvalid, lengths, q in and out back in
            # bf16; operations on the same rows
            live_keys = mask.sum(1)
            keys = int(live_keys.sum())
            dead_rows = int((nvalid.long().clamp(0, nsel) * (live_keys == 0)).sum()) * bs
            nbytes = ((2 * keys + dead_rows) * KH * D * kc.element_size() + 4 * B * (nsel + 2)
                      + 2 * 2 * B * KH * G * D)
            record("block_sparse_decode_attention",
                   f"B={B} S={S} KH={KH} G={G} D={D} block={bs} NSEL={nsel} {kind} {label}",
                   err, tol, ms, plain_ms, lib_ms, nbytes, (4 * keys + 2 * dead_rows) * KH * G * D,
                   rate)
            del kc, vc, kd, vd
        return q

    def table(rows):
        sel = torch.zeros(B, nsel, dtype=torch.int32)
        for b, r in enumerate(rows):
            sel[b, :len(r)] = torch.tensor(r, dtype=torch.int32)
        return sel.to(dev), torch.tensor([len(r) for r in rows], dtype=torch.int32, device=dev)

    lengths = torch.tensor([1025, 1041, 1057, 1073, 1088, 1029, 1064, 1087], dtype=torch.int32,
                           device=dev)
    nvalid = torch.tensor([9, 5, 7, 4, 9, 6, 8, 3], dtype=torch.int32, device=dev)
    rng = torch.Generator().manual_seed(3)
    sel = torch.zeros(B, nsel, dtype=torch.int32)
    for b, n in enumerate(nvalid.tolist()):  # sink 0, recent 7 and 8, then the rest shuffled
        rest = (torch.randperm(6, generator=rng) + 1).tolist()
        sel[b, :n] = torch.tensor(([0, 7, 8] + rest)[:n], dtype=torch.int32)
    sel = sel.to(dev)
    q = case(gen, lengths, nvalid, sel, "lengths mid-block")

    short = torch.Generator(device=dev).manual_seed(17)
    sel1, nv1 = table([[8]] * B)  # the block holding each slot's last keys
    case(short, lengths, nv1, sel1, "one block a slot")
    sel2, nv2 = table([[0, 8]] * B)
    case(short, lengths, nv2, sel2, "two blocks a slot")
    # no live entry (out 0); one block; a first block wholly past the length
    # before a live one; every block past the length (the mean of their V
    # rows); a block cut by the length; two whole blocks
    edge_lengths = torch.tensor([1025, 700, 130, 1088, 1, 300, 2000, 512], dtype=torch.int32,
                                device=dev)
    sel_e, nv_e = table([[], [5], [8, 0], [8], [3, 4], [2, 1], [], [3, 0]])
    case(short, edge_lengths, nv_e, sel_e, "nvalid 0-2, blocks past the length")

    sc = torch.tensor(0.02, device=dev)
    for kind in ("int8", "e4m3"):
        if kind not in kinds:
            continue
        if kind == "int8":
            kc, vc = (torch.randint(-127, 128, (B, S, KH * D), generator=short, device=dev,
                                    dtype=torch.int8) for _ in range(2))
        else:
            kc, vc = (e4m3_codes(torch, short, (B, S, KH * D)) for _ in range(2))
        one_launch(torch, f"block_sparse_decode_attention B={B} S={S} NSEL={nsel} {kind}",
                   lambda: kb.block_sparse_decode_attention(q, kc, vc, sel, nvalid, lengths, sc,
                                                            sc, block_size=bs))


def e4m3_branch_kernels(torch, gen, timer, record) -> None:
    """The e4m3 branches of K5 (``mla_e4m3_kernels``: path N's latent rows
    and the MHA decodes K2 turns away) and K17 (``block_sparse_kernels`` on
    e4m3 caches, path P's); K15's (path O's latent pool) are rows of
    ``paged_kernels``."""
    mla_e4m3_kernels(torch, gen, timer, record)
    block_sparse_kernels(torch, gen, timer, record, kinds=("e4m3",))


def mla_e4m3_kernels(torch, gen, timer, record) -> None:
    """K5 on e4m3 caches. At path N's decode shape (DeepSeek-V2-Lite over an
    e4m3 latent cache: B=8 slots, one shared KV head, G=16, D=640, the same
    e4m3 latent tensor as K and V) the latent cluster kernel's e4m3
    instance, at the int8 rows' lengths: S=2176 (one chunk) lengths
    1..1088, S=512 (two chunks) lengths 1..512, and 33..56 keys (one piece
    a slot: rank 0 alone); each also against the one-CTA body (V a second
    buffer of K's codes) and at one device kernel a call. Then the MHA
    decodes the reference sends to K5 where its K2 says no, at the shapes
    the port's K2 turns away (KH=2, G=16 at D=128 and at D=256, separate
    K and V, S=2176, ragged lengths): the one-CTA body, one device kernel a
    call. e4m3 is the bf16 arithmetic on exactly decoded codes, f32 sums in
    another order than the plain version's: held to it, and the cluster to
    the one-CTA body, at K2's e4m3 bar, 1e-3 plus one bf16 ulp of the
    largest output."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import attention as ka

    dev, B = "cuda", 8
    log("K5 decode_attention, e4m3 caches")
    short = torch.tensor([33, 40, 56, 50, 47, 36, 45, 52], dtype=torch.int32, device=dev)
    ragged = torch.tensor([1024, 1501, 8, 2176, 301, 1025, 2001, 1], dtype=torch.int32,
                          device=dev)
    cases = [(S, 1, 16, 640, top) for S, top in ((2176, 1088), (512, 512), (2176, None))]
    cases += [(2176, 2, 16, 128, "ragged"), (2176, 2, 16, 256, "ragged")]
    for S, KH, G, D, top in cases:
        q = (torch.randn(B, KH, G, D, generator=gen, device=dev) * 2).to(torch.bfloat16)
        kc = e4m3_codes(torch, gen, (B, S, KH * D))
        vc = kc if KH == 1 else e4m3_codes(torch, gen, (B, S, KH * D))
        if top == "ragged":
            lengths, label = ragged, "ragged lengths"
        elif top:
            lengths = torch.linspace(1, top, B, device=dev).round().to(torch.int32)
            label = f"K=V lengths 1..{top}"
        else:
            lengths, label = short, "K=V lengths 33..56"
        sc = torch.tensor(0.011, device=dev)
        out = ka.decode_attention(q, kc, vc, lengths, sc, sc)
        ref = ka.decode_attention_plain(q, kc, vc, lengths, sc, sc)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-3 + _ulp_bf16(ref.float().abs().max().item())
        if KH == 1:
            vc2 = kc.clone()  # V a second buffer: the one-CTA body
            one = ka.decode_attention(q, kc, vc2, lengths, sc, sc)
            same_as_one_cta(torch, f"K5 e4m3 S={S} {label}", out, one, tol)
        one_launch(torch, f"decode_attention e4m3 S={S} KH={KH} D={D} {label}",
                   lambda: ka.decode_attention(q, kc, vc, lengths, sc, sc))
        ms = timer(lambda: ka.decode_attention(q, kc, vc, lengths, sc, sc))
        plain_ms = timer(lambda: ka.decode_attention_plain(q, kc, vc, lengths, sc, sc), 5)
        kd = (kc.float() * sc).to(torch.bfloat16).reshape(B, S, KH, D).transpose(1, 2)
        vd = kd if KH == 1 else (vc.float() * sc).to(torch.bfloat16).reshape(
            B, S, KH, D).transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None].long())
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q.reshape(B, KH * G, 1, D), kd, vd, attn_mask=mask[:, None, None, :],
            enable_gqa=True))
        del kd, vd
        live = int(lengths.clamp(max=S).long().sum())
        # the live rows once (K = V aliased: once), q in, out back, bf16
        nbytes = (1 if KH == 1 else 2) * live * KH * D + 2 * B * KH * G * D * 2
        record("decode_attention", f"B={B} S={S} KH={KH} G={G} D={D} e4m3 {label}", err, tol,
               ms, plain_ms, lib_ms, nbytes, 4 * live * KH * G * D, BF16_FLOPS)
        if KH == 1:  # the same row on the one-CTA body, which the cluster must beat
            record("decode_attention", f"B={B} S={S} KH=1 G={G} D={D} e4m3 one-CTA body "
                   f"{label.replace('K=V', 'K, V two buffers,')}",
                   (one.float() - ref.float()).abs().max().item(), tol,
                   timer(lambda: ka.decode_attention(q, kc, vc2, lengths, sc, sc)), plain_ms,
                   lib_ms, 2 * live * D + 2 * B * G * D * 2, 4 * live * G * D, BF16_FLOPS)


def flash_kernels(torch, gen, timer, record) -> None:
    """K14 at J's calibration forwards (B=2, T=S=1024, KH=8, G=4, D=128,
    bf16: the tensor-core tile, f32 probabilities split hi + lo), with a
    sliding window and sink tokens (D=64; at T = 1024 whole key tiles lie
    outside every row's window and are skipped), and with a row count that
    is not a multiple of the 64-row tile (f32: the CUDA-core tile; bf16)."""
    import torch.nn.functional as F

    from modelopt_tpu_torch.kernels import flash_attention as kf

    dev = "cuda"
    # K14: online softmax over 64-key tiles against the one-pass plain
    # version, both in f32: the rescaled sums differ in rounding, at most
    # S * 2^-24 * max|v| for S keys; then the output rounds to q's dtype,
    # one ulp of the largest output in bf16.
    log("K14 flash_attention")
    cases = ((2, 1024, 8, 4, 128, None, 0, torch.bfloat16, "causal"),
             (1, 512, 2, 4, 64, 64, 4, torch.bfloat16, "window=64 sink=4"),
             (1, 200, 2, 1, 128, None, 0, torch.float32, "200 rows causal"),
             (1, 1024, 2, 4, 64, 128, 4, torch.bfloat16, "window=128 sink=4"),
             (1, 200, 2, 1, 128, None, 0, torch.bfloat16, "200 rows causal"))
    # the cases from the fourth on draw from a generator of their own (see K4)
    gen_new = torch.Generator(device=dev).manual_seed(14)
    for i, (B, T, KH, G, D, window, sink, dt, label) in enumerate(cases):
        if i == 3:
            gen = gen_new
        q = torch.randn(B, T, KH, G, D, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(B, T, KH, D, generator=gen, device=dev).to(dt) for _ in range(2))
        fa = dict(causal=True, window=window, sink=sink)
        out = kf.flash_attention(q, k, v, **fa)
        ref = kf.flash_attention_plain(q, k, v, **fa)
        err = (out.float() - ref.float()).abs().max().item()
        tol = T * 2.0**-24 * v.float().abs().max().item()
        if dt == torch.bfloat16:
            tol += _ulp_bf16(ref.float().abs().max().item())
        ms = timer(lambda: kf.flash_attention(q, k, v, **fa))
        plain_ms = timer(lambda: kf.flash_attention_plain(q, k, v, **fa), 5)
        # the library call: SDPA on the same q / k / v, KV heads repeated
        # beforehand; causal, or with the window's key mask
        qs = q.reshape(B, T, KH * G, D).transpose(1, 2)
        kr, vr = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
        valid = kf._valid_keys(T, T, True, window, sink, dev)
        sdpa = (dict(is_causal=True) if window is None else dict(attn_mask=valid))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, kr, vr, **sdpa))
        del kr, vr
        pairs = int(valid.sum())
        item = q.element_size()
        nbytes = item * (2 * q.numel() + k.numel() + v.numel())
        shape = (f"B={B} T=S={T} KH={KH} G={G} D={D} "
                 f"{'bf16' if dt == torch.bfloat16 else 'f32'} {label}")
        record("flash_attention", shape, err, tol, ms, plain_ms, lib_ms, nbytes,
               4 * B * KH * G * D * pairs, BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        del q, k, v


def w4a16_bar(torch, ref, x, wdq) -> float:
    """How far a W4A16 kernel may sit from its plain version: both multiply
    the same bf16 x by the same exact weights in f32 and differ only in the
    order of the f32 sums (tensor-core MMA against the plain matmul inside
    a block, and where a cluster splits the blocks, partials from zero
    summed in rank order), at most K * 2^-24 * max(|x| @ |w|) for any
    order; a sum that differs in its last f32 bits may then round to the
    neighbouring bf16, one bf16 ulp of the largest output."""
    K = x.shape[-1]
    order = K * 2.0**-24 * torch.matmul(x.abs().float(), wdq.abs().float()).max().item()
    top = ref.float().abs().max().item()
    return order + 2.0 ** (math.floor(math.log2(top)) - 7)


def one_launch(torch, what: str, fn) -> None:
    """``fn`` (one wrapper call on inputs already in place and in the
    kernel's dtype) runs as exactly one device kernel: its partial sums,
    where it splits K, are added inside that launch. The profile counts the
    host's CUDA API calls that put work on the card (kernel launches,
    copies and memsets) and the device's records of
    that work, during a second call of ``fn``: the first call is the
    profiler's warm-up step, which turns the device tracing on. On the card
    a window opened just before the call often held the launch call but no
    kernel record (K17's cluster kernel: every one of ten windows in one
    run, none with the warm-up step), so the host's count decides; a device
    record, where there is one, must name that one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    calls = [ev.key for ev in events if ev.device_type == DeviceType.CPU
             and any(k in ev.key for k in ("Launch", "Memcpy", "Memset")) for _ in range(ev.count)]
    # the step's own span is drawn on the device's timeline too
    names = [ev.key for ev in events if ev.device_type == DeviceType.CUDA
             and not ev.key.startswith("ProfilerStep") for _ in range(ev.count)]
    if len(calls) != 1 or len(names) > 1:
        raise AssertionError(f"{what}: {len(calls)} launch calls {calls} and {len(names)} "
                             f"device kernels {names}, want one of each")
    log(f"  {what}: one launch call ({calls[0]}), "
        + (f"one device kernel ({names[0][:60]})" if names else "no device record"))


def byte_codes_exact(torch, name: str, fn) -> None:
    """Every byte code of K7's int8 / K8's e4m3 weights (e4m3 without its
    NaN codes 0x7f / 0xff) read back through the decode tile (M = 16) and
    the wgmma tile (M = 128) of the wrapper: x holds one-hot rows, the scale
    is 1, so each output is one weight exactly; f32 out, bit for bit."""
    dev = "cuda"
    K, N = 512, 128
    codes = torch.arange(K * N, device=dev) % 256
    if name == "wfp8_gemm":
        codes = torch.where((codes & 0x7F) == 0x7F, 0, codes)
        data = codes.to(torch.uint8).view(torch.float8_e4m3fn).reshape(K, N)
        scale = torch.ones(1, 1, device=dev)
    else:
        data = codes.to(torch.uint8).view(torch.int8).reshape(K, N)
        scale = torch.ones(1, N, device=dev)
    for M in (16, 128):
        got = torch.cat([fn(torch.eye(K, device=dev, dtype=torch.bfloat16)[r0:r0 + M], data, scale,
                            out_dtype=torch.float32) for r0 in range(0, K, M)])
        if not torch.equal(got, data.float()):
            raise AssertionError(f"{name} M={M}: {(got != data.float()).sum().item()} byte codes "
                                 "decode wrong")
    log(f"  {name}: all {len(codes.unique())} byte codes exact through both tiles")


def nvfp4_codes_exact(torch) -> None:
    """Every pair of an e2m1 code (16) and an e4m3 block scale (254: no NaN
    codes 0x7f / 0xff) read back through K9's decode tile (M = 16) and its
    wgmma tile (M = 128): weight row k holds code k % 16 in every column,
    the 2 x 128 scale rows run through the e4m3 codes, x holds one-hot rows
    and scale2 is 1, so each output is one scaled weight exactly; f32 out,
    bit for bit against the exact product."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq

    dev = "cuda"
    K, N = 512, 128
    K2 = K // 2
    code = torch.arange(K, device=dev) % 16  # weight row k's code
    packed = (code[:K2] | (code[K2:] << 4)).to(torch.uint8)[:, None].expand(K2, N).contiguous()
    sc = torch.arange(K // 16 * N, device=dev) % 256
    sc = torch.where((sc & 0x7F) == 0x7F, 0, sc).to(torch.uint8).view(torch.float8_e4m3fn)
    scale = sc.reshape(K // 16, N)
    scale2 = torch.ones(1, 1, device=dev)
    want = kq.nvfp4_unit_weights(packed, scale)
    rows = scale.view(torch.uint8).tolist()
    pairs = {(k % 16, b) for k in range(K) for b in rows[k // 16]}
    if len(pairs) != 16 * 254:
        raise AssertionError(f"nvfp4 codes: {len(pairs)} (code, scale) pairs, want {16 * 254}")
    for M in (16, 128):
        got = torch.cat([kq.nvfp4_gemm(torch.eye(K, device=dev, dtype=torch.bfloat16)[r0:r0 + M],
                                       packed, scale, scale2, out_dtype=torch.float32)
                         for r0 in range(0, K, M)])
        if not torch.equal(got, want):
            raise AssertionError(f"nvfp4_gemm M={M}: {(got != want).sum().item()} (code, scale) "
                                 "pairs decode wrong")
    log(f"  nvfp4_gemm: all {len(pairs)} (e2m1 code, e4m3 scale) pairs exact through both tiles")


def fp_kernels(torch, gen, timer, record) -> None:
    """K7 w8a16_gemm and K8 wfp8_gemm at paths G's and H's projection
    shapes (Llama-3-8B's fused qkv, o, fused gate_up and down), K9
    nvfp4_gemm at path I's (Qwen3-30B-A3B's q, k / v, o and folded gate /
    up), K13 grouped_nvfp4_gemm at I's expert down projection. Rows M hold
    both tiles of each kernel: M = 8 a decode step (the mma.sync decode
    tile), M = 32 the 32-token prefill bucket of the profile windows and the
    small NVFP4 parity, M = 128 the small FP8 parity's prefill (the wgmma
    tile, split over a cluster where its tiles are few); K7 / K8 / K9 also
    at M = 1 and 16 (the decode tile's edges) for N = 4096, and at M = 17,
    64, 65, 200 and 256 (the wgmma tile's 64- and 128-token tiles and their
    tails), K13 at 1, 8, 16, 17 and 32; K13 at path R's expert down
    projection (K = 1408, a 64-row tail) at 1, 8, 16 and 32, K9 at K =
    1408 at 8, 32 and 128, one device kernel a call at M <= 16. Each kernel
    and its plain version multiply the same bf16 x by the same weights,
    exact in bf16 (int8, e4m3, e2m1 times its e4m3 block scale), in f32, and
    apply the f32 scale once: they differ only in the order of the f32 sums,
    the W4A16 bar of the dequantized weight. The library call multiplies x
    by the dequantized bf16 weight. K7 and K8 also read every byte code
    back through both tiles (x one-hot rows, scale 1), bit for bit, and run
    as one device kernel a call at M = 8, 32 and 128; K9 reads every (e2m1
    code, e4m3 scale) pair back likewise, and K9 at M = 8 on each shape and
    at M = 128 on N = 512, K13 at M = 8 and 32, run as one device kernel a
    call."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant import qtensor as qt_

    dev = "cuda"
    for name, quant, dequant in (("w8a16_gemm", qt_.quantize_int8, qt_.dequantize_int8),
                                 ("wfp8_gemm", qt_.quantize_fp8, qt_.dequantize_fp8)):
        log(f"{'K7' if name == 'w8a16_gemm' else 'K8'} {name}")
        fn, plain = getattr(kq, name), getattr(kq, name + "_plain")
        byte_codes_exact(torch, name, fn)
        for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
            w = torch.randn(K, N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
            qt = quant(w)
            wdq = dequant(qt).to(torch.bfloat16)
            del w
            if N == 4096:  # one launch a call: the decode tile's cluster sum, the wgmma tile's
                for M in (8, 32, 128) if K == 4096 else (8,):
                    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                    one_launch(torch, f"{name} M={M} K={K} N={N}",
                               lambda: fn(x, qt["data"], qt["scale"]))
            rows = ((1, 8, 16, 17, 32, 64, 65, 128, 200, 256) if (K, N) == (4096, 4096) else
                    (1, 8, 16, 32, 128) if N == 4096 else (8, 32, 128))
            for M in rows:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                y = fn(x, qt["data"], qt["scale"])
                ref = plain(x, qt["data"], qt["scale"])
                err = (y.float() - ref.float()).abs().max().item()
                tol = w4a16_bar(torch, ref, x, wdq)
                ms = timer(lambda: fn(x, qt["data"], qt["scale"]))
                plain_ms = timer(lambda: plain(x, qt["data"], qt["scale"]), 5)
                lib_ms = timer(lambda: torch.matmul(x, wdq))
                nbytes = M * K * 2 + K * N + qt["scale"].numel() * 4 + M * N * 2
                record(name, f"M={M} K={K} N={N} bf16 out", err, tol, ms, plain_ms, lib_ms,
                       nbytes, 2 * M * K * N, BF16_FLOPS)
            del qt, wdq

    log("K9 nvfp4_gemm")
    nvfp4_codes_exact(torch)
    for K, N in ((2048, 4096), (2048, 512), (4096, 2048), (2048, 98304)):
        w = torch.randn(K, N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
        qt = qt_.quantize_nvfp4(w)
        wdq = qt_.dequantize_nvfp4(qt).to(torch.bfloat16)
        del w
        args = (qt["data"], qt["scale"], qt["scale2"])
        # one launch a call: the decode tile's cluster sum, the wgmma tile's
        for M in (8, 128) if N == 512 else (8,):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            one_launch(torch, f"nvfp4_gemm M={M} K={K} N={N}", lambda: kq.nvfp4_gemm(x, *args))
        for M in (1, 8, 16, 17, 32, 64, 65, 128, 200, 256) if N == 4096 else (8, 32, 128):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            y = kq.nvfp4_gemm(x, *args)
            ref = kq.nvfp4_gemm_plain(x, *args)
            err = (y.float() - ref.float()).abs().max().item()
            tol = w4a16_bar(torch, ref, x, wdq)
            ms = timer(lambda: kq.nvfp4_gemm(x, *args))
            plain_ms = timer(lambda: kq.nvfp4_gemm_plain(x, *args), 5)
            lib_ms = timer(lambda: torch.matmul(x, wdq))
            nbytes = M * K * 2 + K * N // 2 + (K // 16) * N + 4 + M * N * 2
            record("nvfp4_gemm", f"M={M} K={K} N={N} bf16 out", err, tol, ms, plain_ms,
                   lib_ms, nbytes, 2 * M * K * N, BF16_FLOPS)
        del qt, wdq

    # I's decode down projection: E=128 experts of [768, 2048], folded
    log("K13 grouped_nvfp4_gemm")
    E, K, N = 128, 768, 2048
    w = torch.randn(K, E * N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    qt = qt_.quantize_nvfp4(w)
    del w
    wdq = qt_.dequantize_nvfp4(qt).to(torch.bfloat16).reshape(K, E, N).transpose(0, 1) \
        .contiguous()
    args = (qt["data"], qt["scale"], qt["scale2"], N)
    expert_rows(torch, timer, record, "grouped_nvfp4_gemm",
                lambda x: kq.grouped_nvfp4_gemm(x, *args),
                lambda x: kq.grouped_nvfp4_gemm_plain(x, *args), wdq,
                [torch.randn(E, M, K, generator=gen, device=dev).to(torch.bfloat16)
                 for M in (1, 8, 16, 17, 32)], (8, 32), "bf16 out",
                K * N // 2 + (K // 16) * N)
    del qt, wdq

    nvfp4_tail_rows(torch, gen, timer, record)


def nvfp4_tail_rows(torch, gen, timer, record) -> None:
    """K13 at path R's expert down projection (E=64 experts of [1408, 2048],
    K/2 = 5 x 128 + 64: each CTA's walk ends with a 64-row tail) at M = 1,
    8, 16, 32 and K9 at the same K (no ported model has a plain NVFP4
    product there) at M = 8, 32, 128: each expert held to its plain version
    at the W4A16 bar, as the aligned rows; one device kernel a call at
    M <= 16."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant import qtensor as qt_

    dev = "cuda"
    E, K, N = 64, 1408, 2048
    for name, e_, Ms in (("grouped_nvfp4_gemm", E, (1, 8, 16, 32)),
                         ("nvfp4_gemm", 1, (8, 32, 128))):
        log(f"{'K13' if e_ > 1 else 'K9'} {name}, 64-row tail")
        w = torch.randn(K, e_ * N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
        qt = qt_.quantize_nvfp4(w)
        del w
        wdq = qt_.dequantize_nvfp4(qt).to(torch.bfloat16).reshape(K, e_, N).transpose(0, 1) \
            .contiguous()
        args = (qt["data"], qt["scale"], qt["scale2"])
        if e_ > 1:
            fn, plain = (lambda x: kq.grouped_nvfp4_gemm(x, *args, N),
                         lambda x: kq.grouped_nvfp4_gemm_plain(x, *args, N))
        else:
            fn, plain = (lambda x: kq.nvfp4_gemm(x[0], *args)[None],
                         lambda x: kq.nvfp4_gemm_plain(x[0], *args)[None])
        expert_rows(torch, timer, record, name, fn, plain, wdq,
                    [torch.randn(e_, M, K, generator=gen, device=dev).to(torch.bfloat16)
                     for M in Ms], (1, 8, 16), "bf16 out (64-row tail)",
                    K * N // 2 + (K // 16) * N)
        del qt, wdq


def expert_rows(torch, timer, record, name, fn, plain, wdq, xs, launch_ms, suffix,
                weight_bytes) -> None:
    """Rows of a bf16-activation weight GEMM, one for each x [E, M, K] of
    ``xs`` (E = 1 for a plain product): ``fn`` and its plain version
    ``plain`` give [E, M, N]; each expert is held to its plain version at
    the W4A16 bar (``wdq`` [E, K, N] the dequantized bf16 weight, which the
    library call ``bmm`` multiplies); one device kernel a call at the M in
    ``launch_ms``. ``weight_bytes``: an expert's packed weight and scale
    bytes; ``suffix`` ends the row's shape."""
    for x in xs:
        E, M, K = x.shape
        N = wdq.shape[-1]
        shape = (f"E={E} " if name.startswith("grouped") else "") + f"M={M} K={K} N={N}"
        if M in launch_ms:
            one_launch(torch, f"{name} {shape}", lambda: fn(x))
        y, ref = fn(x), plain(x)
        errs = [(y[e].float() - ref[e].float()).abs().max().item() for e in range(E)]
        bars = [w4a16_bar(torch, ref[e], x[e], wdq[e]) for e in range(E)]
        if any(a > b for a, b in zip(errs, bars)):
            raise AssertionError(f"{name} {shape}: an expert exceeds its bar")
        err = max(errs)
        tol = bars[errs.index(err)]
        ms = timer(lambda: fn(x))
        plain_ms = timer(lambda: plain(x), 5)
        lib_ms = timer(lambda: torch.bmm(x, wdq))
        record(name, f"{shape} {suffix}".strip(), err, tol, ms, plain_ms, lib_ms,
               E * M * K * 2 + E * weight_bytes + E * M * N * 2, 2 * E * M * K * N, BF16_FLOPS)


def moe_kernels(torch, gen, timer, record) -> None:
    """K6, K10, K12 and K11 at the Qwen3-30B-A3B paths' shapes, K12, K11
    and K10 also at DeepSeek-V2-Lite's (straddle K), K6 at its K = 1408;
    then K12's shared-memory count."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant.qtensor import dequantize_int4, quantize_int4

    dev = "cuda"
    log("K6 w4a16_gemm")
    # q_proj, k_proj / v_proj, o_proj, the folded gate / up experts
    for K, N in ((2048, 4096), (2048, 512), (4096, 2048), (2048, 98304)):
        w = torch.randn(K, N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
        qt = quantize_int4(w)
        wdq = dequantize_int4(qt).to(torch.bfloat16)
        del w
        # M = 32: the 32-row bucket of the profile windows (the wgmma tile's
        # one-token-tile instance), at one small N and at the folded experts;
        # M = 1 and 16: the decode tile's edges where it splits the blocks
        # over a cluster of 8 (k / v, o)
        for M in (8, 32, 544) if N in (4096, 98304) else (1, 8, 16, 544):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            if M == 8 and N == 512:
                one_launch(torch, "w4a16_gemm M=8 N=512",
                           lambda: kq.w4a16_gemm(x, qt["data"], qt["scale"]))
            y = kq.w4a16_gemm(x, qt["data"], qt["scale"])
            ref = kq.w4a16_gemm_plain(x, qt["data"], qt["scale"])
            err = (y.float() - ref.float()).abs().max().item()
            tol = w4a16_bar(torch, ref, x, wdq)
            ms = timer(lambda: kq.w4a16_gemm(x, qt["data"], qt["scale"]))
            plain_ms = timer(lambda: kq.w4a16_gemm_plain(x, qt["data"], qt["scale"]), 5)
            lib_ms = timer(lambda: torch.matmul(x, wdq))
            nbytes = M * K * 2 + K * N // 2 + (K // 128) * N * 4 + M * N * 2
            record("w4a16_gemm", f"M={M} K={K} N={N} bf16 out", err, tol, ms, plain_ms,
                   lib_ms, nbytes, 2 * M * K * N, BF16_FLOPS)
        del qt, wdq

    # K10 and K12 at the decode down-projection: E=128 experts of
    # [768, 2048] in the folded layout
    E, K, N = 128, 768, 2048
    w = torch.randn(K, E * N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    qt = quantize_int4(w)
    del w
    wdq = dequantize_int4(qt).to(torch.bfloat16).reshape(K, E, N).transpose(0, 1).contiguous()
    per_expert = K * N // 2 + (K // 128) * N * 4  # packed bytes + scale bytes
    log("K10 grouped_w4a16_gemm")
    # K6's arithmetic per expert: the same bar, expert by expert; M = 32 the
    # wgmma tile the 32-row bucket reaches through grouped_qgemm
    expert_rows(torch, timer, record, "grouped_w4a16_gemm",
                lambda x: kq.grouped_w4a16_gemm(x, qt["data"], qt["scale"], N),
                lambda x: kq.grouped_w4a16_gemm_plain(x, qt["data"], qt["scale"], N), wdq,
                [torch.randn(E, M, K, generator=gen, device=dev).to(torch.bfloat16)
                 for M in (1, 8, 32)], (8,), "", per_expert)

    log("K12 grouped_w4a8_combine_gemm")
    combine_rows(torch, gen, timer, record, qt, wdq, E, K, N, 8,
                 ((8, "routed"), (8, "dense"), (1, "routed"), (32, "routed"), (8, "zero"),
                  (8, "single")))
    log("K11 grouped_w4a8_gemm")
    gateless_rows(torch, gen, timer, record, qt, wdq, E, K, N, (8, 32, 1, 16))
    del qt, wdq
    # DeepSeek-V2-Lite's decode down projection: 64 experts of [1408, 2048],
    # K/2 = 704 = 5 * 128 + 64, so one scale block straddles the halves
    E, K, N = 64, 1408, 2048
    w = torch.randn(K, E * N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    qt = quantize_int4(w)
    del w
    wdq = dequantize_int4(qt).to(torch.bfloat16).reshape(K, E, N).transpose(0, 1).contiguous()
    combine_rows(torch, gen, timer, record, qt, wdq, E, K, N, 6, ((8, "routed"),))
    gateless_rows(torch, gen, timer, record, qt, wdq, E, K, N, (8,))
    w4a16_straddle_rows(torch, gen, timer, record, qt, wdq, E, K, N)
    del qt, wdq
    combine_smem_agrees(torch)


def w4a16_straddle_rows(torch, gen, timer, record, qt, wdq, E, K, N) -> None:
    """K10 at DeepSeek-V2-Lite's straddle shape (``qt``, ``wdq``: its
    folded int4 experts; path Q's expert down projection at decode and the
    32-row bucket) at M = 1, 8, 16, 32, and K6 at the same K (no ported
    model has a plain int4 product there) at M = 8, 32, 544: each expert
    held to its plain version at the W4A16 bar, one device kernel a call
    at M <= 16."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq
    from modelopt_tpu_torch.quant.qtensor import dequantize_int4, quantize_int4

    dev = "cuda"
    per_expert = K * N // 2 + (K // 128) * N * 4  # packed bytes + scale bytes
    log("K10 grouped_w4a16_gemm, straddle K")
    expert_rows(torch, timer, record, "grouped_w4a16_gemm",
                lambda x: kq.grouped_w4a16_gemm(x, qt["data"], qt["scale"], N),
                lambda x: kq.grouped_w4a16_gemm_plain(x, qt["data"], qt["scale"], N), wdq,
                [torch.randn(E, M, K, generator=gen, device=dev).to(torch.bfloat16)
                 for M in (1, 8, 16, 32)], (1, 8, 16), "bf16 out (straddle)", per_expert)
    log("K6 w4a16_gemm, straddle K")
    w = torch.randn(K, N, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    q1 = quantize_int4(w)
    del w
    expert_rows(torch, timer, record, "w4a16_gemm",
                lambda x: kq.w4a16_gemm(x[0], q1["data"], q1["scale"])[None],
                lambda x: kq.w4a16_gemm_plain(x[0], q1["data"], q1["scale"])[None],
                dequantize_int4(q1).to(torch.bfloat16)[None],
                [torch.randn(1, M, K, generator=gen, device=dev).to(torch.bfloat16)
                 for M in (8, 32, 544)], (8,), "bf16 out (straddle)", per_expert)


def combine_smem_agrees(torch) -> None:
    """K12's shared memory as the wrapper's plan counts it
    (``quant_gemm._combine_smem`` within ``SMEM_LIMIT``) against the
    kernel's own count (``grouped_w4a8_combine_smem``: ``combine_smem``
    within ``MAX_SMEM``), at every cluster size and held-slot count the
    launch takes, for 1-256 experts, each token tile and aligned and
    straddle K: a plan the picker makes is one the launch accepts."""
    from modelopt_tpu_torch.kernels import _build
    from modelopt_tpu_torch.kernels import quant_gemm as kq

    fn = _build.function("grouped_w4a8_combine_smem", [_build.c_int] * 5, "grouped_w4a8_gemm")
    n = 0
    for E in (1, 2, 7, 8, 64, 100, 128, 160, 256):
        for M in (1, 8, 16, 32, 200):
            for K2 in (64, 384, 704, 768, 2816):
                for r in (1, 2, 4, 8, 16):
                    for slots in ((0,) if r == 1 else range(1, -(-E // r) + 1)):
                        want = kq._combine_smem(E, M, K2, r, slots)
                        want = want if want <= kq.SMEM_LIMIT else -1
                        got = fn(E, M, K2, r, slots)
                        n += 1
                        if got != want:
                            raise AssertionError(
                                f"grouped_w4a8_combine_gemm E={E} M={M} K2={K2} R={r} "
                                f"slots={slots}: the kernel takes {got} bytes of shared "
                                f"memory, the plan counts {want}")
    log(f"K12: the plan's shared memory equals the kernel's at {n} (E, M, K2, R, slots) "
        "points")


def gateless_rows(torch, gen, timer, record, qt, wdq, E, K, N, Ms) -> None:
    """K11 rows at one expert geometry: each expert's exact integer dots
    and f32 block updates rounded as the plain version rounds them, written
    as they stand: bit-exact (tolerance 0), and the same bits on a second
    launch; one device kernel a call at M = 8. Every expert's weights are
    read (no gates skip any). The library call multiplies the bf16 codes by
    the dequantized bf16 weights."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq

    dev = "cuda"
    per_expert = K * N // 2 + (K // 128) * N * 4  # packed bytes + scale bytes
    straddle = " (straddle)" if (K // 2) % 128 else ""
    for M in Ms:
        xq = torch.randint(-127, 128, (E, M, K), generator=gen, device=dev, dtype=torch.int8)
        if M == 8:
            one_launch(torch, f"grouped_w4a8_gemm E={E} M={M} K={K}",
                       lambda: kq.grouped_w4a8_gemm(xq, qt["data"], qt["scale"], N))
        y = kq.grouped_w4a8_gemm(xq, qt["data"], qt["scale"], N)
        ref = kq.grouped_w4a8_gemm_plain(xq, qt["data"], qt["scale"], N)
        if not torch.equal(y.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"grouped_w4a8_gemm E={E} M={M}: not the plain version bit "
                                 f"for bit (max abs err {(y - ref).abs().max().item()})")
        err = (y - ref).abs().max().item()
        if not torch.equal(y, kq.grouped_w4a8_gemm(xq, qt["data"], qt["scale"], N)):
            raise AssertionError("grouped_w4a8_gemm: two launches differ")
        ms = timer(lambda: kq.grouped_w4a8_gemm(xq, qt["data"], qt["scale"], N))
        plain_ms = timer(lambda: kq.grouped_w4a8_gemm_plain(xq, qt["data"], qt["scale"], N), 5)
        xb = xq.to(torch.bfloat16)
        lib_ms = timer(lambda: torch.bmm(xb, wdq))
        record("grouped_w4a8_gemm", f"E={E} M={M} K={K} N={N} no gates{straddle}", err, 0.0,
               ms, plain_ms, lib_ms, E * (M * K + per_expert + M * N * 4), 2 * E * M * K * N,
               INT8_OPS)


def combine_rows(torch, gen, timer, record, qt, wdq, E, K, N, top_k, cases) -> None:
    """K12 rows at one expert geometry, one for each (M, kind) of ``cases``.
    Exact integer dots, each expert's f32 block update and gated term
    rounded as the plain version rounds them, the terms summed in expert
    order: bit-exact (tolerance 0), and the same bits on a second launch.
    gscale as the W4A8 decode makes it (``routed``: ``top_k`` experts per
    row, gate x the row's activation scale), dense random (``dense``), no
    row routed at all (``zero``: the output is +0), or each used expert
    routed by exactly one row (``single``). The kernel reads only the
    experts some row is routed to; the bound counts that work: their
    weights, the products of non-zero (expert, row) pairs. One device
    kernel a call at M = 8 (routed)."""
    from modelopt_tpu_torch.kernels import quant_gemm as kq

    dev = "cuda"
    per_expert = K * N // 2 + (K // 128) * N * 4  # packed bytes + scale bytes
    for M, kind in cases:
        xs = torch.rand(E, M, 1, generator=gen, device=dev) * 0.05
        xq = torch.randint(-127, 128, (E, M, K), generator=gen, device=dev, dtype=torch.int8)
        gates = torch.zeros(E, M, device=dev)
        if kind == "routed":
            top = torch.rand(M, E, generator=gen, device=dev).topk(top_k, dim=-1).indices
            gates.T.scatter_(1, top, torch.rand(M, top_k, generator=gen, device=dev) / 4)
        elif kind == "dense":
            gates = torch.rand(E, M, generator=gen, device=dev)
        elif kind == "single":
            pick = torch.randperm(E, generator=gen, device=dev)[:M]
            gates[pick, torch.arange(M, device=dev)] = torch.rand(M, generator=gen,
                                                                  device=dev) / 4
        gsc = (xs[..., 0] * gates).contiguous()
        xfq = (xq.float() * xs).to(torch.bfloat16)
        if M == 8 and kind == "routed":
            one_launch(torch, f"grouped_w4a8_combine_gemm E={E} M={M} K={K}",
                       lambda: kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"], N))
        y = kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"], N)
        ref = kq.grouped_w4a8_combine_gemm_plain(xq, gsc, qt["data"], qt["scale"], N)
        if not torch.equal(y.view(torch.int32), ref.view(torch.int32)):
            err = (y - ref).abs().max().item()
            raise AssertionError(f"grouped_w4a8_combine_gemm E={E} M={M} {kind}: not the "
                                 f"plain version bit for bit (max abs err {err})")
        err = (y - ref).abs().max().item()
        if not torch.equal(y, kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"],
                                                           N)):
            raise AssertionError("grouped_w4a8_combine_gemm: two launches differ")
        ms = timer(lambda: kq.grouped_w4a8_combine_gemm(xq, gsc, qt["data"], qt["scale"], N))
        plain_ms = timer(lambda: kq.grouped_w4a8_combine_gemm_plain(
            xq, gsc, qt["data"], qt["scale"], N), 5)
        gb = gates.to(torch.bfloat16)
        lib_ms = timer(lambda: torch.einsum("emn,em->mn", torch.bmm(xfq, wdq), gb))
        used = int((gsc != 0).any(dim=1).sum())
        pairs = int((gsc != 0).sum())
        record("grouped_w4a8_combine_gemm",
               f"E={E} M={M} K={K} N={N} {kind} gscale ({used} experts used)", err, 0.0, ms,
               plain_ms, lib_ms,
               used * (M * K + per_expert) + E * M * 4 + M * N * 4, 2 * pairs * K * N,
               INT8_OPS)


# --------------------------------------------------------------------------
# phase 3: small models on the card against the same models on the CPU
# --------------------------------------------------------------------------
def _numpy_variables(cfg, preset, seed=0, router_scale=0.1):
    """Reference-layout variables (nested dict of numpy arrays) drawn from a
    numpy seed: packed weights for the quantized projections, as CPU
    tensors (int4, e4m3 or NVFP4; expert kernels packed in their folded
    [in, E*out] view, MLA's absorbed kv_b_proj like a linear layer), f32
    kernels where no packed format fits (fake-quantized in every forward),
    f32 embedding / lm_head / router / norm scales."""
    import numpy as np
    import torch

    from modelopt_tpu_torch.models.mla import AbsorbedKernel
    from modelopt_tpu_torch.models.transformer import Decoder, Router
    from modelopt_tpu_torch.nn.layers import QuantDense, QuantEinsum, QuantEmbed, RMSNorm
    from modelopt_tpu_torch.quant.config import get_config
    from modelopt_tpu_torch.quant.qtensor import (compressible_format, fold_experts,
                                                  quantize_qtensor)

    rng = np.random.default_rng(seed)
    qcfg = get_config(preset)
    params: dict = {}
    quant: dict = {}

    def put(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    for mod in Decoder(cfg, device="meta").modules():
        path = mod.path.split("/")
        if isinstance(mod, (QuantDense, QuantEinsum, AbsorbedKernel)):
            shape = (mod.kernel_shape if isinstance(mod, QuantEinsum)
                     else (mod.in_features, mod.features))
            w = rng.standard_normal(shape).astype(np.float32)
            w /= np.sqrt(shape[-2])
            specs = qcfg.resolve(mod.path + "/weight_quantizer")
            wt = torch.from_numpy(w)
            w2 = wt if wt.dim() == 2 else fold_experts(wt)
            if specs and compressible_format(specs[0], tuple(w2.shape)):
                qt, _ = quantize_qtensor(w2, specs[0])
                for k, v in qt.items():  # tensors: e4m3 has no numpy dtype here
                    put(quant, path + ["qweight", k], v)
            else:
                put(params, path + ["kernel"], w)
        elif isinstance(mod, Router):
            put(params, path + ["kernel"], (router_scale * rng.standard_normal(
                tuple(mod.kernel.shape))).astype(np.float32))
        elif isinstance(mod, QuantEmbed):
            put(params, path + ["embedding"],
                rng.standard_normal(tuple(mod.embedding.shape)).astype(np.float32))
        elif isinstance(mod, RMSNorm):
            put(params, path + ["scale"],
                (1.0 + 0.1 * rng.standard_normal(tuple(mod.scale.shape))).astype(np.float32))
    return {"params": params, "quant": quant}


def _router_trace(bundle) -> list:
    """Hook every MoE block of ``bundle`` to record each routing's router
    logits and selected experts (on the CPU)."""
    from modelopt_tpu_torch.models.transformer import MoEBlock

    trace = []
    for blk in (m for m in bundle.module.modules() if isinstance(m, MoEBlock)):
        def route(x, blk=blk, orig=blk.route):
            gates, sel, scores = orig(x)
            trace.append((blk.router(x).float().cpu(), sel.sort(-1).values.cpu()))
            return gates, sel, scores
        blk.route = route
    return trace


def _fake_quant_trace(bundle) -> list:
    """Hook every TensorQuantizer of ``bundle`` to record each call that
    fake-quantizes or returns cache codes (an int8 or e4m3 KV cache's
    ``with_scale`` call): (path, input, keyword arguments, output or
    codes), on the CPU."""
    from modelopt_tpu_torch.nn.quantizer import TensorQuantizer

    trace = []

    def hook(mod, args, kwargs, out):
        if isinstance(out, tuple):
            if out[1] is None:
                return
            out = out[0]
        if out is not args[0]:
            trace.append((mod.path, args[0].detach().cpu().clone(), kwargs,
                          out.detach().cpu().clone()))
    for mod in bundle.module.modules():
        if isinstance(mod, TensorQuantizer):
            mod.register_forward_hook(hook, with_kwargs=True)
    return trace


def _replay_fake_quant(torch, name, trace, gpu) -> None:
    """Run each recorded fake-quant or cache-code call again through the
    card model's quantizer of the same path, on the same input: the output
    must be the CPU's bit for bit (amax, true divisions, the e4m3 cast and
    the bf16 rounding are all correctly rounded on both devices)."""
    from modelopt_tpu_torch.nn.quantizer import TensorQuantizer

    quantizers = {m.path: m for m in gpu.module.modules() if isinstance(m, TensorQuantizer)}
    if not trace:
        raise AssertionError(f"parity {name}: no fake-quant call recorded")
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    with gpu.contexts(), torch.no_grad():
        for path, x, kwargs, want in trace:
            got = quantizers[path](x.to("cuda"), **kwargs)
            got = (got[0] if isinstance(got, tuple) else got).cpu()
            if not (got.dtype == want.dtype and torch.equal(
                    got.view(ints[got.element_size()]), want.view(ints[want.element_size()]))):
                raise AssertionError(f"parity {name}: {path} fake-quantizes another way on "
                                     f"the card")
    log(f"  {name}: {len(trace)} fake-quant and cache-code calls of "
        f"{len({t[0] for t in trace})} quantizers repeated on the card on the CPU's inputs: "
        "bit-identical")


def _forward_rows(torch, bundle, cfg, ids, T, steps, kv_dtype, dev, paged=False):
    """Prefill ids[:, :T] into a fresh cache of 256 rows a slot, then
    ``steps`` cached decode steps; the last position's logits of each
    forward, [steps + 1, B, V], on the CPU. ``paged``: a paged cache of
    64-row pages instead, the slots' pages handed out in turns (slot 0 gets
    1, 3, 5, 7, ...)."""
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.serve.paged_cache import (PagedCacheConfig, make_paged_cache,
                                                      write_page_table)

    B = ids.shape[0]
    if paged:
        pmax = 256 // PAGE_SIZE
        cache = make_paged_cache(cfg, B, PagedCacheConfig(PAGE_SIZE, B * pmax + 1, pmax),
                                 dtype=kv_dtype, device=dev)
        for b in range(B):
            write_page_table(cache, b, list(range(b + 1, B * pmax + 1, B)))
    else:
        cache = make_cache(cfg, B, 256, dtype=kv_dtype, device=dev)
    out, cache = bundle.apply(ids[:, :T].to(dev), cache)
    rows = [out[:, -1].float().cpu()]
    for t in range(steps):
        out, cache = bundle.apply(ids[:, T + t:T + t + 1].to(dev), cache)
        rows.append(out[:, -1].float().cpu())
    return torch.stack(rows)


def cpu_reference(torch, cfg, preset, kv_dtype, ids_seed, B, T, steps, paged=False):
    """The CPU half of a parity check: variables drawn from numpy seed 0,
    the model built on the CPU and calibrated there (its k/v amax written
    into the variables, so the card runs with the same scales), the ids
    (torch seed ``ids_seed``), the CPU's logits, its routing trace and its
    fake-quant trace."""
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.convert import from_jax_variables
    from modelopt_tpu_torch.quant.api import calibrate

    variables = _numpy_variables(cfg, preset)
    ids = torch.randint(1, cfg.vocab_size, (B, T + steps), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(ids_seed))
    cpu = from_jax_variables(variables, cfg, preset, device="cpu")
    calibrate(cpu, "max", lambda f: f(ids[:, :T], make_cache(cfg, B, 256, device="cpu")))
    for mod in cpu.module.modules():
        if getattr(mod, "amax", None) is not None:
            node = variables["quant"]
            for k in mod.path.split("/"):
                node = node.setdefault(k, {})
            node["amax"] = mod.amax.numpy()
    trace = _router_trace(cpu)
    fq_trace = _fake_quant_trace(cpu)
    logits = _forward_rows(torch, cpu, cfg, ids, T, steps, kv_dtype, "cpu", paged)
    return variables, ids, logits, trace, fq_trace


def _perturbed_sums(torch, rel: float, seed: int = 0):
    """While active, the plain versions of K7, K8 and K9 scale each f32 sum
    by (1 + rel * u), u uniform in [-1, 1] from ``seed``, before their
    scale and output rounding: another order of the same f32 sums, as a
    kernel's tensor cores take (the order bar allows up to K * 2^-24)."""
    import contextlib

    from modelopt_tpu_torch.kernels import quant_gemm as kq

    @contextlib.contextmanager
    def ctx():
        gen = torch.Generator().manual_seed(seed)
        real = {n: getattr(kq, n) for n in ("w8a16_gemm_plain", "wfp8_gemm_plain",
                                             "nvfp4_gemm_plain")}

        def wrap(fn):
            def f(x, *args, out_dtype=torch.bfloat16, **kw):
                y = fn(x, *args, out_dtype=torch.float32, **kw)
                u = 2 * torch.rand(y.shape, generator=gen) - 1
                return (y * (1 + rel * u)).to(out_dtype)
            return f

        try:
            for n, fn in real.items():
                setattr(kq, n, wrap(fn))
            yield
        finally:
            for n, fn in real.items():
                setattr(kq, n, fn)
    return ctx()


def _parity(torch, name, cfg, preset, kv_dtype, ids_seed, B, T, steps=4, paged=False,
            noise_floor=False):
    """Prefill of B x T tokens then ``steps`` decode steps, the same numpy
    weights on the CPU (plain versions) and on the card (kernels); holds the
    card's logits to 3% of the largest CPU logit. The int8 GEMMs (K1, K12)
    are exact on both devices; bf16 rounding of activations, of attention
    probabilities (online vs one-pass softmax), of K6/K10's f32 sums (MMA vs
    plain order) and of the lm_head product differ. For a routed model the
    log gives how many routings chose the same experts on both devices, the
    largest router-logit difference and the smallest top-k gap of the CPU
    run (the ids are chosen so that gap is well above the difference).

    ``noise_floor``: static e4m3 activations (FP8_DEFAULT_CFG) round every
    projection's input to 3 mantissa bits, so a last-bit change of a bf16
    activation near an e4m3 midpoint moves it by a whole e4m3 step. The CPU
    model is run once more with its GEMMs' f32 sums changed by 2^-20 of
    themselves (``_perturbed_sums``, far less than the card's other order);
    the largest logit change of that run, the floor no order of the sums
    can get under, is added to the bar (0.127 on the llama, against a 3%
    bar of 0.134, on the CPU). So that this floor hides no fault of the
    activations' fake-quant, each of the CPU run's fake-quant calls is
    repeated on the card on the same input and must give the same bits
    (``_replay_fake_quant``); the GEMMs are held to their plain versions
    at this parity's M in the kernel phase."""
    from modelopt_tpu_torch.models.convert import from_jax_variables

    variables, ids, ref, cpu_trace, fq_trace = cpu_reference(
        torch, cfg, preset, kv_dtype, ids_seed, B, T, steps, paged)
    floor = 0.0
    if noise_floor:
        with _perturbed_sums(torch, 2.0**-20):
            again = from_jax_variables(variables, cfg, preset, device="cpu")
            floor = (_forward_rows(torch, again, cfg, ids, T, steps, kv_dtype, "cpu", paged)
                     - ref).abs().max().item()
    gpu = from_jax_variables(variables, cfg, preset, device="cuda")
    if noise_floor:
        _replay_fake_quant(torch, name, fq_trace, gpu)
    gpu_trace = _router_trace(gpu)
    got = _forward_rows(torch, gpu, cfg, ids, T, steps, kv_dtype, "cuda", paged)
    if not (torch.isfinite(got).all() and got.shape == (steps + 1, B, cfg.vocab_size)):
        raise AssertionError(f"parity {name}: card logits not finite or misshaped")
    err = (got - ref).abs().max().item()
    tol = 3e-2 * ref.abs().max().item() + floor
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    # a greedy choice whose top-2 logits are this close may go either way
    top2 = ref.topk(2, -1).values
    tie = (top2[..., 0] - top2[..., 1]).min().item()
    routed = ""
    if cpu_trace:
        k = cfg.experts_per_token
        if len(cpu_trace) != len(gpu_trace):
            raise AssertionError(f"parity {name}: {len(cpu_trace)} CPU routings, "
                                 f"{len(gpu_trace)} on the card")
        dlog = max((a[0] - b[0]).abs().max().item() for a, b in zip(cpu_trace, gpu_trace))
        same = sum(int((a[1] == b[1]).all(-1).sum()) for a, b in zip(cpu_trace, gpu_trace))
        total = sum(a[1][..., 0].numel() for a in cpu_trace)
        gap_c, gap_o = router_gaps(cpu_trace, k)
        routed = (f", routings with the same top-{k} experts {same}/{total}, router logits "
                  f"differ by <= {dlog:.3g}; smallest CPU top-{k} gap {gap_c:.3g} at the "
                  f"compared positions, {gap_o:.3g} elsewhere")
    log(f"  {name}: prefill {B} x {T} + {steps} decode steps: max |logit diff| {err:.4g} "
        f"(tol {tol:.4g}" + (f", of which the CPU's noise floor {floor:.4g}" if noise_floor
                             else "")
        + f"), argmax agreement {agree:.3f} (smallest CPU top-2 logit gap {tie:.4g}){routed}")
    if not err <= tol:
        raise AssertionError(f"parity {name}: card logits off by {err} > {tol}")


def router_gaps(trace, k: int):
    """Smallest gap between the k-th and (k+1)-th router logit of a trace:
    (at the positions whose logits are compared, the prefill's last token
    and every decode step; at the other prefill positions)."""
    compared, other = [], []
    for lg, _ in trace:
        top = lg.topk(k + 1, -1).values
        gap = top[..., k - 1] - top[..., k]  # [B, T]
        compared.append(gap[:, -1].min().item())
        if gap.shape[1] > 1:
            other.append(gap[:, :-1].min().item())
    return min(compared), min(other)


def small_moe_config():
    """A 2-layer Qwen3-MoE at the real per-expert geometry: hidden 2048,
    expert width 768, 32 heads and 4 KV heads of D=128 (G=8), 8 experts,
    top-2, qk-norm, vocab 4096."""
    from modelopt_tpu_torch.models import qwen3_moe_config

    return qwen3_moe_config(num_layers=2, num_experts=8, experts_per_token=2,
                            vocab_size=4096, max_position_embeddings=256)


# torch seed of the small MoE's ids (2 x 16 prefill tokens, 4 decode steps,
# 2 layers): on the CPU, under both presets, every top-2 choice at a compared
# position is at least 0.21 in router logits from a tie, every other at
# least 0.03 (a flip there reaches the compared logits only through
# attention). A choice flipped at a compared position would move the
# logits by a whole expert's output.
MOE_IDS_SEED = 44
# the same for the NVFP4 weights (path I's preset), which route otherwise:
# on seed 27 every top-2 choice at a compared position is at least 0.20
# from a tie, every other at least 0.11 (seed 44 leaves 0.09 and 0.015)
MOE_NVFP4_IDS_SEED = 27


def small_mla_config():
    """A 2-layer DeepSeek-V2 at the real attention and expert widths of
    DeepSeek-V2-Lite: hidden 2048, 16 heads, r=512, dr=64 (a 640-lane
    latent row), yarn, a dense first layer of width 10944, expert width
    1408 (straddle blocks), 2 shared experts; 8 experts, top-2, vocab
    4096."""
    from modelopt_tpu_torch.models import deepseek_v2_lite_config

    return deepseek_v2_lite_config(num_layers=2, num_experts=8, experts_per_token=2,
                                   vocab_size=4096, max_position_embeddings=256)


# torch seed of the small DeepSeek's ids (2 x 16 prefill tokens, 4 decode
# steps, 1 routed layer): on the CPU every top-2 choice at a compared
# position is at least 0.8 in router logits from a tie, every other at
# least 0.05.
MLA_IDS_SEED = 1
# the same under FP8_KV_CFG (paths N, O), which routes otherwise: on seed 6
# every top-2 choice at a compared position is at least 0.24 from a tie,
# every other at least 0.21 (seed 1 leaves 0.11 and 0.08)
MLA_FP8_IDS_SEED = 6


@contextlib.contextmanager
def selection_trace(torch, margins: bool = True):
    """While active, every ``select_blocks`` call of the decoder appends
    (sel, nvalid[, margins]) to the yielded list: margins are the smallest
    distance of an in-range, unforced block's bound from the keep threshold
    and the smallest gap between two kept, unforced bounds (how far the
    selection and its order are from changing)."""
    from modelopt_tpu_torch.models import transformer
    from modelopt_tpu_torch.sparsity.skip_softmax import block_upper_bounds

    real = transformer.select_blocks
    trace = []

    def record(q, kmax, kmin, lengths, cfg):
        sel, nvalid = real(q, kmax, kmin, lengths, cfg)
        if not margins:
            trace.append((sel, nvalid))
            return sel, nvalid
        ub = block_upper_bounds(q, kmax, kmin)
        nb = ub.shape[1]
        n_blocks = (lengths.long()[:, None] + cfg.block_size - 1) // cfg.block_size
        bidx = torch.arange(nb, device=ub.device)[None]
        free = (bidx < n_blocks) & (bidx >= cfg.sink_blocks) & (
            bidx < n_blocks - cfg.recent_blocks)
        m = torch.where(bidx < n_blocks, ub, -math.inf).amax(1, keepdim=True)
        gap = torch.where(free, (ub - (m - cfg.tau)).abs(), math.inf).min()
        kept = torch.where(free & (ub >= m - cfg.tau), ub, -math.inf).sort(1).values
        steps = (kept[:, 1:] - kept[:, :-1])
        order = torch.where(torch.isfinite(steps), steps, math.inf).min()
        trace.append((sel, nvalid, torch.stack([gap, order])))
        return sel, nvalid

    transformer.select_blocks = record
    try:
        yield trace
    finally:
        transformer.select_blocks = real


def skip_llama_config(torch):
    """The skip-softmax parity llama: hidden 512, 4 heads and 2 KV heads of
    D=128, 2 layers, vocab 4096, fused projections, in f32 (its int8 KV
    cache and 7-bit codes as on path J): with bf16 activations the card's
    and the CPU's logits differ by bf16 ulps, as large as the gaps that
    decide greedy tokens and block selection."""
    from modelopt_tpu_torch.models import llama_config

    return llama_config(vocab_size=4096, hidden_size=512, num_layers=2, num_heads=4,
                        num_kv_heads=2, intermediate_size=1024, max_position_embeddings=1024,
                        rope_theta=500000.0, fused_qkv=True, fused_gate_up=True,
                        dtype=torch.float32)


# the skip-softmax parity: 2 prompts of 640 tokens (10 of the cache's 16
# 64-row blocks), 4 greedy decode steps at tau SKIP_TAU, budget 0.5 (11
# table entries). On the CPU, with torch seed SKIP_IDS_SEED, every in-range
# unforced block's bound is at least 0.0047 from the keep threshold, two
# kept bounds at least 0.009 apart, and every greedy choice 0.149 from a
# tie.
SKIP_TAU, SKIP_IDS_SEED, SKIP_PROMPT, SKIP_STEPS, SKIP_MAXLEN = 0.5, 458, 640, 4, 1024


def _skip_decode(torch, bundle, cache, tok, dev):
    """SKIP_STEPS greedy decode steps from ``cache`` (written in place) and
    the first token ``tok`` [B]: (logits of every step [steps, B, V] on the
    CPU, the tokens fed [steps, B], the selection trace on the CPU)."""
    rows, toks = [], []
    with selection_trace(torch) as trace:
        for _ in range(SKIP_STEPS):
            toks.append(tok)
            out, cache = bundle.apply(tok[:, None].to(dev), cache)
            rows.append(out[:, -1].float().cpu())
            tok = rows[-1].argmax(-1).to(torch.int32)
    return torch.stack(rows), torch.stack(toks), [tuple(t.cpu() for t in r) for r in trace]


def skip_parity(torch, preset="W4A8_INT8KV_CFG", kv_dtype=None,
                label: str = "W4A8 + int8 KV") -> None:
    """The skip-softmax llama under ``preset`` with a ``kv_dtype`` KV cache
    (W4A8_INT8KV_CFG and int8, path J's; or no quantizer and an e4m3 cache,
    the keys and values cast with scale 1, K17's e4m3 branch), 64-row
    blocks: the same numpy weights on the CPU (K1, K3 and K17's twins) and
    on the card (the kernels), any KV amax calibrated on the CPU and
    carried over. Each device prefills the prompts into its own cache:
    last-position logits within the llama parity's 3% of the largest CPU
    logit. Then both decode greedily from the CPU's prefilled cache (copied
    to the card): greedy tokens, every step's and layer's ``sel`` and
    ``nvalid`` equal, logits within the same bar. Decoding from one cache
    state holds the block selection to the decode path: the two prefills
    round some of the 1280 tokens' int8 activation and KV codes the other
    way (last-bit differences of their inputs), which moves bounds by more
    than a selection's margins (the selections of an H100's own prefill
    differed at margins of 0.0047)."""
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.convert import from_jax_variables
    from modelopt_tpu_torch.quant.api import calibrate
    from modelopt_tpu_torch.sparsity import sparsify_attention_dynamic

    cfg = skip_llama_config(torch)
    kv_dtype = kv_dtype or torch.int8
    variables = _numpy_variables(cfg, preset)
    ids = torch.randint(1, cfg.vocab_size, (2, SKIP_PROMPT), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(SKIP_IDS_SEED))
    cpu = from_jax_variables(variables, cfg, preset, device="cpu")
    calibrate(cpu, "max", lambda f: f(ids[:, :64], make_cache(cfg, 2, 64, device="cpu")))
    for mod in cpu.module.modules():
        if getattr(mod, "amax", None) is not None:
            node = variables["quant"]
            for k in mod.path.split("/"):
                node = node.setdefault(k, {})
            node["amax"] = mod.amax.numpy()
    ss = dict(block_size=64, tau=SKIP_TAU, budget=0.5)
    cpu = sparsify_attention_dynamic(cpu, **ss)
    gpu = sparsify_attention_dynamic(from_jax_variables(variables, cfg, preset, device="cuda"),
                                     **ss)
    caches, pre = {}, {}
    for dev, bundle in (("cpu", cpu), ("cuda", gpu)):
        cache = make_cache(bundle.module.cfg, 2, SKIP_MAXLEN, kv_dtype, device=dev)
        out, caches[dev] = bundle.apply(ids.to(dev), cache)
        pre[dev] = out[:, -1].float().cpu()
    pre_err = (pre["cuda"] - pre["cpu"]).abs().max().item()
    shared = {k: (tuple(t.to("cuda") for t in v) if isinstance(v, tuple) else v.to("cuda"))
              for k, v in caches["cpu"].items()}
    first = pre["cpu"].argmax(-1).to(torch.int32)
    ref, ref_tok, ref_trace = _skip_decode(torch, cpu, caches["cpu"], first, "cpu")
    got, tok, trace = _skip_decode(torch, gpu, shared, first, "cuda")
    if not (torch.isfinite(got).all() and got.shape == ref.shape
            and torch.isfinite(pre["cuda"]).all()):
        raise AssertionError("skip parity: card logits not finite or misshaped")
    err = (got - ref).abs().max().item()
    tol = 3e-2 * max(pre["cpu"].abs().max().item(), ref.abs().max().item())
    same_sel = len(trace) == len(ref_trace) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(trace, ref_trace))
    margins = torch.stack([r[2] for r in ref_trace]).amin(0).tolist()
    top2 = ref.topk(2, -1).values
    tie = (top2[..., 0] - top2[..., 1]).min().item()
    nv = torch.stack([r[1] for r in ref_trace]).float()
    if not all(t.dtype == kv_dtype for t in shared["k"] + shared["v"]):
        raise AssertionError(f"skip parity {label}: a cache is not {kv_dtype}")
    log(f"  skip-softmax llama {label}, tau {SKIP_TAU}: prefill 2 x {SKIP_PROMPT}, "
        f"each device's own: max |logit diff| {pre_err:.4g}; {SKIP_STEPS} greedy steps from "
        f"the CPU's cache: max |logit diff| {err:.4g} (tol {tol:.4g}), tokens "
        f"{'equal' if torch.equal(tok, ref_tok) else 'DIFFER'}, sel / nvalid of "
        f"{len(ref_trace)} selections {'equal' if same_sel else 'DIFFER'}; nvalid mean "
        f"{nv.mean().item():.2f} of 11 in-range blocks; CPU margins: bound to threshold "
        f"{margins[0]:.3g}, between kept bounds {margins[1]:.3g}, top-2 logit gap {tie:.3g}")
    if not torch.equal(tok, ref_tok):
        raise AssertionError(f"skip parity: greedy tokens differ {tok.tolist()} "
                             f"{ref_tok.tolist()}")
    if not same_sel:
        raise AssertionError("skip parity: the card selected other blocks than the CPU")
    if not (err <= tol and pre_err <= tol):
        raise AssertionError(f"skip parity: card logits off by {err} / {pre_err} > {tol}")


# every quantizer off: a bf16 model (the dense-cache gate parity)
NO_QUANT = {"quant_cfg": {"*weight_quantizer": {"enable": False},
                          "*input_quantizer": {"enable": False},
                          "*output_quantizer": {"enable": False}},
            "algorithm": "max"}


def parity_phase(torch) -> None:
    from modelopt_tpu_torch.models import llama_config, tiny_test_config

    moe = small_moe_config()
    _parity(torch, "Qwen3-MoE W4A8 + int8 KV", moe, "W4A8_INT8KV_CFG", torch.int8,
            MOE_IDS_SEED, 2, 16)
    _parity(torch, "Qwen3-MoE W4A16 + bf16 KV", moe, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG",
            torch.bfloat16, MOE_IDS_SEED, 2, 16)
    _parity(torch, "DeepSeek-V2 W4A8 + int8 latent cache", small_mla_config(),
            "W4A8_INT8KV_CFG", torch.int8, MLA_IDS_SEED, 2, 16)
    llama = llama_config(vocab_size=4096, hidden_size=1024, num_layers=2, num_heads=8,
                         num_kv_heads=2, intermediate_size=2048,
                         max_position_embeddings=256, rope_theta=500000.0,
                         fused_qkv=True, fused_gate_up=True)
    _parity(torch, "llama W4A8 + int8 KV", llama, "W4A8_INT8KV_CFG", torch.int8, 1, 2, 64)
    # paged: prefill gathers the pages for the einsum path, decode runs K15
    # (the twin on the CPU), every forward writes through K16
    _parity(torch, "llama W4A8 + int8 KV pages", llama, "W4A8_INT8KV_CFG", torch.int8, 1, 2,
            64, paged=True)
    _parity(torch, "DeepSeek-V2 W4A8 + int8 latent pages", small_mla_config(),
            "W4A8_INT8KV_CFG", torch.int8, MLA_IDS_SEED, 2, 16, paged=True)
    # paths G and I: K8 (the fp8 activations' amax calibrated on the CPU and
    # carried to the card), K9 and K13 (their twins on the CPU); prefill
    # rows at most 256 ride the kernels too
    _parity(torch, "llama FP8 + bf16 KV", llama, "FP8_DEFAULT_CFG", torch.bfloat16, 1, 2, 64,
            noise_floor=True)
    _parity(torch, "Qwen3-MoE NVFP4 + bf16 KV", moe, "NVFP4_WEIGHT_ONLY_CFG", torch.bfloat16,
            MOE_NVFP4_IDS_SEED, 2, 16)
    # paths Q and R: the experts' K = 1408 through K10's straddle tiles and
    # K13's tail (their twins on the CPU), the dense layer's K = 10944
    # uncompressed (W4A16) or through the dequantize route (NVFP4), a bf16
    # latent cache through the einsum
    _parity(torch, "DeepSeek-V2 W4A16 + bf16 latent cache", small_mla_config(),
            "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", torch.bfloat16, MLA_IDS_SEED, 2, 16)
    _parity(torch, "DeepSeek-V2 NVFP4 weight-only + bf16 latent cache", small_mla_config(),
            "NVFP4_WEIGHT_ONLY_CFG", torch.bfloat16, MLA_IDS_SEED, 2, 16)
    # paths K and L: FP8_KV_CFG's e4m3 caches through K2 / K4 and K15 (the
    # twins on the CPU), e4m3 codes as jumpy as the e4m3 activations, so the
    # same noise floor and replay, the k / v codes replayed too
    _parity(torch, "llama FP8 + e4m3 KV", llama, "FP8_KV_CFG", torch.float8_e4m3fn, 1, 2, 64,
            noise_floor=True)
    _parity(torch, "llama FP8 + e4m3 KV pages", llama, "FP8_KV_CFG", torch.float8_e4m3fn, 1,
            2, 64, paged=True, noise_floor=True)
    # paths N and O: FP8_KV_CFG's e4m3 latent codes through the latent
    # cluster kernel's e4m3 instance (K5, K15; the twins on the CPU), e4m3
    # activations as jumpy as the llama's: the same noise floor and replay
    _parity(torch, "DeepSeek-V2 FP8 + e4m3 latent cache", small_mla_config(), "FP8_KV_CFG",
            torch.float8_e4m3fn, MLA_FP8_IDS_SEED, 2, 16, noise_floor=True)
    _parity(torch, "DeepSeek-V2 FP8 + e4m3 latent pages", small_mla_config(), "FP8_KV_CFG",
            torch.float8_e4m3fn, MLA_FP8_IDS_SEED, 2, 16, paged=True, noise_floor=True)
    # path J: K17 (its twin on the CPU) over the selected blocks; path P's
    # e4m3 branch of K17 on an f32 decoder whose e4m3 cache is the only
    # rounding (no quantizer: keys and values cast, scale 1)
    skip_parity(torch)
    skip_parity(torch, NO_QUANT, torch.float8_e4m3fn, "f32 + e4m3 KV")
    # path M and the PTQ phase: the calibration algorithms themselves, card
    # against CPU
    ptq_parity(torch)
    # the reference's dense-cache gates: at D = 16 neither K2 nor K4 takes
    # the forward, the card writes by K3 and takes the einsum, as the CPU
    _parity(torch, "tiny llama (D = 16) + bf16 KV, gated to the einsum",
            tiny_test_config(dtype=torch.bfloat16), NO_QUANT, torch.bfloat16, 1, 2, 16,
            steps=1)


GATELESS = (128, 768, 2048)  # E, fin, fout: Qwen3-30B-A3B's expert down projection
GATELESS_CALLS = 3


def gateless_phase(torch) -> dict:
    """K11's entry point: the public compressed ``QuantEinsum`` down
    projection ``bteo,eod->bted`` called WITHOUT gates (no served MoE block
    does that: the reference's always passes gates, and its gated path is
    K12's). Built at Qwen3-30B-A3B's expert geometry under W4A8_INT8KV_CFG
    from seeded random weights, on the card and (the same packed weight) on
    the CPU; called GATELESS_CALLS times on [8, 1, 128, 768] bf16
    activations with the launch counters zeroed just before and read just
    after: K11 once a call, no other kernel. The result is the CPU
    module's (K11's twin) bit for bit, and within the W4A8 bar of the f32
    product of the activations and the dequantized weight: each output
    moves by at most half a row scale times its column's sum of |W| (the
    int8 rounding of the activations) plus its bf16 rounding. Returns the
    counts."""
    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.nn.layers import QuantEinsum
    from modelopt_tpu_torch.nn.quantizer import assign_paths, quantization_active
    from modelopt_tpu_torch.quant.config import get_config
    from modelopt_tpu_torch.quant.qtensor import dequantize_qtensor, quantize_qtensor

    E, fin, fout = GATELESS
    cfg = get_config("W4A8_INT8KV_CFG")
    gen = torch.Generator(device="cuda").manual_seed(11)
    w = torch.randn(fin, E * fout, generator=gen, device="cuda", dtype=torch.bfloat16) * 0.02
    spec = cfg.resolve("weight_quantizer")[0]
    qt = quantize_qtensor(w, spec)[0]
    del w
    mods = {}
    for dev in ("cuda", "cpu"):
        mod = QuantEinsum("bteo,eod->bted", GATELESS, dtype=torch.bfloat16, device="meta")
        assign_paths(mod)
        mod.set_qweight({k: v.to(dev) for k, v in qt.items()})
        mods[dev] = mod
    x = torch.randn(8, 1, E, fin, generator=gen, device="cuda").to(torch.bfloat16)
    with quantization_active(cfg), torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        outs = [mods["cuda"](x) for _ in range(GATELESS_CALLS)]
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = kernels.launch_counts()
        want = mods["cpu"](x.cpu())
    got = outs[0].cpu()
    log(f"  {GATELESS_CALLS} calls of QuantEinsum('bteo,eod->bted', {GATELESS}) without gates on "
        f"{tuple(x.shape)} bf16: {wall * 1e3 / GATELESS_CALLS:.2f} ms a call (host clock); "
        f"launches {dict((k, v) for k, v in launches.items() if v)}")
    if launches["grouped_w4a8_gemm"] != GATELESS_CALLS or any(
            v for k, v in launches.items() if k != "grouped_w4a8_gemm"):
        raise AssertionError(f"gateless einsum: launches {launches}, want K11 "
                             f"{GATELESS_CALLS} times and nothing else")
    if not (got.shape == (8, 1, E, fout) and got.dtype == torch.bfloat16
            and all(torch.equal(o, outs[0]) for o in outs)
            and torch.equal(got.view(torch.int16), want.view(torch.int16))):
        raise AssertionError("gateless einsum: the card's result is not the CPU twin's bit "
                             "for bit (or not the same on every call)")
    wf = dequantize_qtensor(qt, spec, (fin, E * fout)).float().reshape(fin, E, fout)
    xf = x[:, 0].float()                                               # [8, E, fin]
    ref = torch.einsum("mek,ken->men", xf, wf)
    xs = xf.abs().amax(-1, keepdim=True) / 127.0                       # [8, E, 1]
    bar = 0.5 * xs * wf.abs().sum(0)[None] + 2.0**-8 * ref.abs() + 1e-6
    err = (outs[0][:, 0].float() - ref).abs()
    log(f"  card = CPU twin bit for bit; against the f32 product of the dequantized weight: "
        f"max |diff| {err.max().item():.4g}, at most {(err / bar).max().item():.3f} of the "
        f"W4A8 bar (max bar {bar.max().item():.4g})")
    if not (err <= bar).all():
        raise AssertionError("gateless einsum: outside the W4A8 bar")
    del mods, outs, wf, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 4: the serving paths on the card
# --------------------------------------------------------------------------
PATHS = {  # name: (title, model, preset, KV cache dtype)
    "B": ("Qwen3-30B-A3B W4A8 + int8 KV", "qwen3_moe", "W4A8_INT8KV_CFG", "int8"),
    "C": ("Qwen3-30B-A3B W4A16 + bf16 KV", "qwen3_moe", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG",
          "bfloat16"),
    "A": ("Llama-3-8B W4A8 + int8 KV", "llama3_8b", "W4A8_INT8KV_CFG", "int8"),
    "D": ("DeepSeek-V2-Lite W4A8 + int8 latent cache", "deepseek_v2_lite", "W4A8_INT8KV_CFG",
          "int8"),
    "E": ("Llama-3-8B W4A8 + int8 KV pages", "llama3_8b", "W4A8_INT8KV_CFG", "int8"),
    "F": ("DeepSeek-V2-Lite W4A8 + int8 latent pages", "deepseek_v2_lite", "W4A8_INT8KV_CFG",
          "int8"),
    "G": ("Llama-3-8B FP8 W8A8 + bf16 KV, 8 of 32 layers", "llama3_8b", "FP8_DEFAULT_CFG",
          "bfloat16"),
    "H": ("Llama-3-8B INT8 weight-only + bf16 KV, 8 of 32 layers", "llama3_8b",
          "INT8_WEIGHT_ONLY_CFG", "bfloat16"),
    "I": ("Qwen3-30B-A3B NVFP4 weight-only + bf16 KV", "qwen3_moe", "NVFP4_WEIGHT_ONLY_CFG",
          "bfloat16"),
    "K": ("Llama-3-8B FP8 W8A8 + e4m3 KV", "llama3_8b", "FP8_KV_CFG", "float8_e4m3fn"),
    "L": ("Llama-3-8B FP8 W8A8 + e4m3 KV pages", "llama3_8b", "FP8_KV_CFG", "float8_e4m3fn"),
    # quantized and compressed on the card (``ptq_path``), not drawn packed
    "M": ("Llama-3-8B INT8 SmoothQuant W8A8 + int8 KV, quantized and compressed on the card",
          "llama3_8b", "INT8_KV_CFG", "int8"),
    "N": ("DeepSeek-V2-Lite FP8 W8A8 + e4m3 latent cache", "deepseek_v2_lite", "FP8_KV_CFG",
          "float8_e4m3fn"),
    "O": ("DeepSeek-V2-Lite FP8 W8A8 + e4m3 latent pages", "deepseek_v2_lite", "FP8_KV_CFG",
          "float8_e4m3fn"),
    "Q": ("DeepSeek-V2-Lite W4A16 + bf16 latent cache", "deepseek_v2_lite",
          "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "bfloat16"),
    "R": ("DeepSeek-V2-Lite NVFP4 weight-only + bf16 latent cache", "deepseek_v2_lite",
          "NVFP4_WEIGHT_ONLY_CFG", "bfloat16"),
    # quantized and compressed on the card, as M
    "S": ("Llama-3-8B NVFP4 SVDQuant W4A4 + bf16 KV, quantized and compressed on the card",
          "llama3_8b", "NVFP4_SVDQUANT_CFG", "bfloat16"),
}
# the paths quantized and compressed on the card (``ptq_path``)
PTQ_PATHS = ("M", "S")
# the skip-softmax paths at the Decoder level (``skip_path``): name ->
# (title, preset, KV cache dtype), on Llama-3-8B
SKIP_PATHS = {"J": ("Llama-3-8B W4A8 + int8 KV", "W4A8_INT8KV_CFG", "int8"),
              "P": ("Llama-3-8B FP8 W8A8 + e4m3 KV", "FP8_KV_CFG", "float8_e4m3fn")}
# paths served at a cut depth, to keep the script well inside its time
# limit on a slow host (which ran the whole script ~35% longer than a fast
# one): Llama-3-8B 8 of 32 layers (G, H, K, L, J, P, S) or 16 (E, M),
# Qwen3-30B-A3B 4 of 48, DeepSeek-V2-Lite 4 of 27 (a dense first layer and 3
# MoE layers); A keeps Llama's 32
PATH_LAYERS = {"G": 8, "H": 8, "K": 8, "L": 8, "E": 16, "M": 16, "J": 8, "P": 8, "B": 4,
               "C": 4, "I": 4, "D": 4, "F": 4, "N": 4, "O": 4, "Q": 4, "R": 4, "S": 8}
# paths over a paged KV cache. A 1024-token request holds at most
# pages_needed(min(1024 + 63 + 16, 2176), 64) = 18 pages (a 16-token burst's
# lookahead from its 63rd token), 8 of them 144, plus the null page.
PAGED = ("E", "F", "L", "O")
# paths whose decode attention is also profiled at ~1024 keys a slot (K5,
# K15 at MLA's geometry), beside the 8 x 32 -> 24 window every path takes
LONG_WINDOW = ("D", "F", "N", "O")
TRAFFIC = (8, 1024, 64)  # requests x prompt tokens -> new tokens, every path


def path_config(torch, model: str, layers: int = None):
    """The path's model configuration at full width; ``layers`` cuts it to
    that depth (by default Qwen3-30B-A3B 24 of 48 layers, DeepSeek-V2-Lite
    14 of 27, Llama-3-8B all 32)."""
    from modelopt_tpu_torch.models import (deepseek_v2_lite_config, llama3_8b_config,
                                           qwen3_moe_config)

    if model == "qwen3_moe":  # full width, 128 experts
        return qwen3_moe_config(num_layers=layers or 24, max_position_embeddings=2176,
                                param_dtype=torch.bfloat16)
    if model == "deepseek_v2_lite":  # full width, 64 + 2 experts
        return deepseek_v2_lite_config(num_layers=layers or 14, param_dtype=torch.bfloat16)
    return llama3_8b_config(max_position_embeddings=2176, param_dtype=torch.bfloat16,
                            fused_qkv=True, fused_gate_up=True, num_layers=layers or 32)


def static_quantizers(bundle) -> list:
    """Paths of the quantizers of ``bundle`` that run in its forward with a
    spec needing a calibrated amax: the int8 KV cache's k / v, FP8's static
    e4m3 activations (a compressed layer's weight quantizer never runs)."""
    from modelopt_tpu_torch.nn.quantizer import TensorQuantizer, _needs_static_amax

    cfg = bundle.records[0].config
    packed = {m.path for m in bundle.module.modules() if getattr(m, "compressed", False)}
    out = []
    for m in bundle.module.modules():
        specs = cfg.resolve(m.path) if isinstance(m, TensorQuantizer) else None
        if (specs and _needs_static_amax(specs[0])
                and not (m.path.endswith("/weight_quantizer")
                         and m.path.rsplit("/", 1)[0] in packed)):
            out.append(m.path)
    return out


def serve_path(torch, name) -> dict:
    """Build path ``name``'s compressed model on the card (random weights,
    seed 0); when it has static quantizers (an int8 KV cache, FP8's
    activations) calibrate them with one 64-token forward; warm the engine
    up with one request, serve TRAFFIC (``measured_run``), profile a window
    of decode ticks, check one more request, and free the model. Returns
    the measured run's launches."""
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
    from modelopt_tpu_torch.quant.api import calibrate, validate_calibration

    title, model, preset, kv = PATHS[name]
    cfg = path_config(torch, model, PATH_LAYERS.get(name))
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_compressed_bundle(cfg, preset, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  built compressed model ({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_experts} experts) in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak while packing "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    if static_quantizers(bundle):
        ids = torch.randint(1, cfg.vocab_size, (1, 64), dtype=torch.int32, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
        calibrate(bundle, "max", lambda f: f(ids, make_cache(cfg, 1, 64, device="cuda")))
        bad = validate_calibration(bundle)
        n_amax = sum(getattr(m, "amax", None) is not None for m in bundle.module.modules())
        log(f"  calibrated: {n_amax} quantizers hold an amax, {len(bad)} invalid")
    return serve_bundle(torch, name, bundle, cfg)


def serve_bundle(torch, name, bundle, cfg) -> dict:
    """Serve path ``name`` from its compressed, calibrated ``bundle``: warm
    the engine up with one request, serve TRAFFIC (``measured_run``; on
    path M also counting ``int8_dynamic_gemm``'s calls), take the prefill
    window of ``PREFILL_SPLIT``, profile a window of decode ticks, check one
    more request, and free the model. Returns the measured run's
    launches."""
    from modelopt_tpu_torch.serve import ServingEngine, run_serving_benchmark

    kv_dtype = getattr(torch, PATHS[name][3])
    paging = (dict(paged=True, page_size=PAGE_SIZE, kv_pages=PAGED_POOL) if name in PAGED
              else {})
    eng = ServingEngine(bundle, max_batch=8, max_seq_len=2176, prefill_buckets=(32, 544),
                        kv_dtype=kv_dtype, multi_step=16, max_admit=1, device="cuda", **paging)
    caches = eng.cache["k"] + eng.cache["v"]
    kv_bytes = sum(t.numel() * t.element_size() for t in caches)
    if paging:
        dense = sum(t[0].numel() * t.element_size() * 8 * 2176 // PAGE_SIZE
                    for t in eng.cache["k"] + eng.cache["v"])
        log(f"  KV pools {PAGED_POOL} pages of {PAGE_SIZE} rows: {kv_bytes / 1e9:.3f} GB, "
            f"against {dense / 1e9:.3f} GB for the dense cache of 8 x 2176 rows")
    else:
        log(f"  KV cache {kv_bytes / 1e9:.3f} GB")
    t0 = time.time()
    run_serving_benchmark(eng, n_requests=1, input_len=TRAFFIC[1], output_len=8,
                          vocab=cfg.vocab_size)
    log(f"  warm-up request {time.time() - t0:.1f} s")
    with dynamic_gemm_calls() as calls, dequantize_calls() as dequantized:
        launches = measured_run(torch, eng, name)
    if name == "R":
        # the reference's NVFP4 rule (K % 128 == 0) sends the dense layer's
        # K = 10944 down projection to the dequantize route in every forward,
        # decode steps included (K9 would refuse it)
        dense = sum(k == 10944 for k in dequantized)
        forwards = eng.stats["prefill_chunks"] + eng.stats["decode_forwards"]
        log(f"  dequantize route at K = 10944 (no kernel): {dense} calls in the measured run, "
            f"one a forward ({forwards} forwards)")
        if dense != forwards:
            raise AssertionError(f"path R: {dense} K = 10944 dequantize calls, want one a "
                                 f"forward ({forwards})")
    if name == "S":
        # the reference's NVFP4 rule sends every projection of every prefill
        # chunk (544 and 480 rows, above 256) to the dequantize route
        want = 4 * cfg.num_layers * eng.stats["prefill_chunks"]
        log(f"  dequantize route above 256 rows (no kernel): {len(dequantized)} calls in the "
            f"measured run, 4 projections x {cfg.num_layers} layers x "
            f"{eng.stats['prefill_chunks']} prefill chunks")
        if len(dequantized) != want:
            raise AssertionError(f"path S: {len(dequantized)} dequantize calls, want {want}")
    if name == "M":
        # every projection of every 544-row prefill chunk, and nothing else
        per_chunk = 4 * cfg.num_layers
        log(f"  int8_dynamic_gemm: {len(calls)} calls in the measured run, all at M = "
            f"{sorted(set(calls))} ({len(calls) // per_chunk} prefill chunks of "
            f"{eng.stats['prefill_chunks']} x 4 projections x {cfg.num_layers} layers)")
        if not calls or len(calls) % per_chunk or min(calls) <= 256:
            raise AssertionError(f"path M: int8_dynamic_gemm calls {len(calls)}")
    elif calls:
        raise AssertionError(f"path {name}: {len(calls)} int8_dynamic_gemm calls")
    if name in PREFILL_SPLIT:
        prefill_window(torch, bundle, cfg, kv_dtype, name)
    # the cache tensors the kernels wrote are the path's dtype (K and L:
    # e4m3, so the kernels' e4m3 branches ran, not the bf16 ones)
    if not all(t.dtype == kv_dtype for t in eng.cache["k"] + eng.cache["v"] + caches):
        raise AssertionError(f"path {name}: a cache is not {kv_dtype}")
    log(f"  every cache tensor is {kv_dtype}")
    profile_window(torch, eng, 8, 32, 24, cfg.vocab_size)
    if name in LONG_WINDOW:
        context_window(torch, eng, 8, TRAFFIC[1], cfg.vocab_size)
    check_output(torch, eng, cfg.vocab_size)
    if paging and eng.allocator.free_pages != PAGED_POOL - 1:
        raise AssertionError(f"path {name}: {eng.allocator.free_pages} pages free at the end, "
                             f"expected {PAGED_POOL - 1}")
    del eng, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SKIP_CALIB_BATCHES = 4  # RULER batches of 2 x 1024 tokens for path J's tau


def skip_path(torch, name: str = "J") -> dict:
    """A skip-softmax path at the Decoder level (the reference engine cannot
    serve a skip-softmax bundle, so neither does the port's): Llama-3-8B at
    ``PATH_LAYERS``' depth under the path's preset (``SKIP_PATHS``; J: path
    A's W4A8_INT8KV_CFG, P: FP8_KV_CFG), seed 0, its static quantizers (KV
    scales, P's e4m3 activations) calibrated by one 64-token forward, then,
    with the launch counters zeroed, ``calibrate_skip_softmax`` on RULER
    needle batches (uncached capture forwards: K1 or K8, and K14) with the
    reference's defaults (recall 0.99, 128-row blocks, its tau grid, budget
    1.0), a cache of 8 x 2176 rows of the path's KV dtype (int8, e4m3) with
    block summaries, 8 random prompts of 1024 tokens prefilled through
    ``bundle.apply`` in two chunks (544 + 480, as the engine's buckets split
    them: the masked einsum over the cache), and 64 greedy decode steps (K3
    writes, K17 over the selected blocks). Asserts the launches (the path's
    kernels > 0, K17 = layers x 64, K3 = layers x 66, every other kernel 0),
    a cache of the path's dtype, finite logits and in-vocabulary tokens;
    logs tau, recalls, the worst head, the rates and how many of the
    in-range blocks each decode step attended; then profiles 16 more decode
    steps. Returns the counts."""
    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.models.synthetic import build_compressed_bundle
    from modelopt_tpu_torch.quant.api import calibrate
    from modelopt_tpu_torch.sparsity import calibrate_skip_softmax, ruler_needle_batches
    from torch.profiler import ProfilerActivity, profile

    _, preset, kv = SKIP_PATHS[name]
    kv_dtype = getattr(torch, kv)
    cfg = path_config(torch, "llama3_8b", PATH_LAYERS.get(name))
    n_req, in_len, steps = 8, 1024, 64
    bundle = build_compressed_bundle(cfg, preset, seed=0, device="cuda")
    ids = torch.randint(1, cfg.vocab_size, (1, 64), dtype=torch.int32, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    calibrate(bundle, "max", lambda f: f(ids, make_cache(cfg, 1, 64, device="cuda")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    t0 = time.time()
    batches = ruler_needle_batches(cfg.vocab_size, num_batches=SKIP_CALIB_BATCHES, batch_size=2,
                                   seq_len=in_len, device="cuda")
    sb, info = calibrate_skip_softmax(bundle, batches)
    torch.cuda.synchronize()
    log(f"  calibrate_skip_softmax on {SKIP_CALIB_BATCHES} RULER batches of 2 x {in_len}: "
        f"{time.time() - t0:.1f} s, tau {info['tau']}, recalls {info['recalls']}, worst head "
        f"{info['worst_head']}")

    prompts = torch.randint(1, cfg.vocab_size, (n_req, in_len), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)).to("cuda")
    cache = make_cache(sb.module.cfg, n_req, 2176, kv_dtype, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    for lo, hi in ((0, 544), (544, in_len)):  # the engine's bucket split
        last = torch.full((n_req,), hi - lo - 1, dtype=torch.int32, device="cuda")
        logits, cache = sb.apply(prompts[:, lo:hi], cache, logits_index=last)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_prefill = time.time() - t0
    toks = [tok]
    with selection_trace(torch, margins=False) as trace:
        t0 = time.time()
        for _ in range(steps):
            logits, cache = sb.apply(toks[-1][:, None], cache)
            toks.append(logits[:, -1].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        t_decode = time.time() - t0
    launches = kernels.launch_counts()
    out = torch.stack(toks, 1)
    if not (torch.isfinite(logits).all() and ((out >= 0) & (out < cfg.vocab_size)).all()
            and int(cache["lengths"][0]) == in_len + steps
            and all(t.dtype == kv_dtype for t in cache["k"] + cache["v"])):
        raise AssertionError(f"path {name}: bad logits, tokens, lengths or cache dtype")
    nvalid = torch.stack([t[1] for t in trace]).float()            # [steps * layers, B]
    in_range = -(-(in_len + steps) // sb.module.cfg.skip_softmax.block_size)
    new = n_req * (steps + 1)
    log(f"  {n_req} prompts x {in_len} -> {steps + 1} new tokens (1 from the prefill, "
        f"{steps} decode steps): prefill {t_prefill:.2f} s, decode {t_decode:.2f} s, output "
        f"{new / (t_prefill + t_decode):.1f} tok/s, decode {n_req * steps / t_decode:.1f} "
        f"tok/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  blocks attended per decode step and layer: nvalid mean {nvalid.mean().item():.3f}, "
        f"min {int(nvalid.min().item())} of {in_range} in range at the last step (skipped "
        f"share {1 - nvalid.mean().item() / in_range:.3f})")
    log(f"  launches on path {name}: {launches}")
    if launches["block_sparse_decode_attention"] != cfg.num_layers * steps:
        raise AssertionError(f"path {name}: {launches['block_sparse_decode_attention']} K17 "
                             f"launches, expected {cfg.num_layers * steps}")
    if launches["dense_kv_write"] != cfg.num_layers * (2 + steps):  # K and V in one launch
        raise AssertionError(f"path {name}: {launches['dense_kv_write']} K3 launches, expected "
                             f"{cfg.num_layers * (2 + steps)}")
    missing = [k for k in PATH_KERNELS[name] if launches[k] <= 0]
    strays = [k for k in launches if k not in PATH_KERNELS[name] and launches[k]]
    if missing or strays:
        raise AssertionError(f"path {name}: never launched {missing}, launched {strays}")

    # profile window: 16 more decode steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(16):
            logits, cache = sb.apply(toks[-1][:, None], cache)
            toks.append(logits[:, -1].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        wall = time.time() - t0
    report_profile(torch, prof, wall, f"{n_req} slots at {in_len + steps} tokens, 16 decode "
                   "steps")
    del sb, bundle, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# post-training quantization on the card: path M, the PTQ phase
# --------------------------------------------------------------------------
@contextlib.contextmanager
def dynamic_gemm_calls():
    """While active, record the row count of every ``int8_dynamic_gemm``
    call (a list, yielded)."""
    from modelopt_tpu_torch.quant import backends as qb

    calls: list = []
    real = qb.int8_dynamic_gemm

    def counted(x2d, *args, **kw):
        calls.append(x2d.shape[0])
        return real(x2d, *args, **kw)

    qb.int8_dynamic_gemm = counted
    try:
        yield calls
    finally:
        qb.int8_dynamic_gemm = real


@contextlib.contextmanager
def dequantize_calls():
    """While active, record the K of every packed weight the GEMM dispatch
    dequantizes (``qgemm``'s and ``grouped_qgemm``'s dequantize route: the
    calls no kernel serves; a list, yielded)."""
    from modelopt_tpu_torch.quant import backends as qb

    calls: list = []
    real = qb.dequantize_qtensor

    def counted(qt, spec, kn):
        calls.append(kn[0])
        return real(qt, spec, kn)

    qb.dequantize_qtensor = counted
    try:
        yield calls
    finally:
        qb.dequantize_qtensor = real


def int8_dynamic_rows(torch, gen, timer, results: dict) -> None:
    """``int8_dynamic_gemm`` (quant/backends.py: per-row int8 codes, the
    s8 x s8 -> s32 product by ``torch._int_mm``, ``acc * xscale * scale``)
    at a 544-row prefill chunk on Llama-3-8B's four projections (path M),
    bit for bit against its plain version (the same codes and scales, the
    s32 product through an exact f64 matmul: |acc| < 2^53), beside the bf16
    ``torch.matmul`` of the same shape (``library_ms``) and the bound
    (2 M K N at the int8 rate, or the bytes); and ``torch._int_mm`` alone
    on the row-major weight against the K-major copy and product the
    function takes. Records the GEMM kernels
    ``torch._int_mm`` launches in it and the weight copy's kernel, for path
    M's prefill split."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from modelopt_tpu_torch.quant import backends as qb
    from modelopt_tpu_torch.quant.qtensor import dequantize_int8, quantize_int8

    record = recorder(results)
    M, dev = 544, "cuda"
    log("int8_dynamic_gemm (torch._int_mm; no hand-written kernel, as the reference's "
        "XLA dot_general)")
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        qt = quantize_int8(torch.randn(K, N, generator=gen, device=dev,
                                       dtype=torch.bfloat16) * 0.02)
        wdq = dequantize_int8(qt).to(torch.bfloat16)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)

        def plain():
            xq, xs = qb._int8_rows(x.float())
            acc = (xq.double() @ qt["data"].double()).float()
            return (acc * xs * qt["scale"]).to(torch.bfloat16)

        y = qb.int8_dynamic_gemm(x, qt["data"], qt["scale"], torch.bfloat16)
        err = (y.float() - plain().float()).abs().max().item()
        ms = timer(lambda: qb.int8_dynamic_gemm(x, qt["data"], qt["scale"], torch.bfloat16))
        plain_ms = timer(plain, 5)
        lib_ms = timer(lambda: torch.matmul(x, wdq))
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        record("int8_dynamic_gemm", f"M={M} K={K} N={N}", err, 0.0, ms, plain_ms, lib_ms,
               nbytes, 2 * M * K * N, INT8_OPS)
        # the layout choice: cuBLAS's product on the row-major weight as
        # given, against the K-major copy and product int8_dynamic_gemm takes
        xq = qb._int8_rows(x.float())[0]
        row_ms = timer(lambda: torch._int_mm(xq, qt["data"]))
        copy_ms = timer(lambda: torch._int_mm(xq, qt["data"].t().contiguous().t()))
        results["int8_dynamic_gemm"][-1].update(int_mm_row_major_ms=row_ms,
                                                 int_mm_k_major_copy_ms=copy_ms)
        log(f"    torch._int_mm alone: row-major weight {row_ms:.4f} ms, K-major copy + "
            f"product {copy_ms:.4f} ms")
        # the device kernels of the call: cuBLAS's GEMM (its tile differs by
        # shape) and the weight's K-major copy; the rest are elementwise. A
        # window opened just before a call can lose its kernel records (as
        # K17's and this copy's did after the kernel phase), so each window
        # has the profiler's warm-up step first, as ``one_launch``'s
        for keep, fn in ((INT_MM_KERNELS, lambda: qb.int8_dynamic_gemm(
                x, qt["data"], qt["scale"], torch.bfloat16)),
                         (WEIGHT_COPY_KERNELS, lambda: qt["data"].t().contiguous())):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            names = {ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
                     and not ev.key.startswith("ProfilerStep")}
            keep.extend(sorted(n for n in names - set(keep)
                               if keep is WEIGHT_COPY_KERNELS or "gemm" in n))
        del qt, wdq, x
    log(f"  int8_dynamic_gemm's GEMM kernels: {[n[:90] for n in INT_MM_KERNELS]}; the "
        f"weight copy's: {[n[:90] for n in WEIGHT_COPY_KERNELS]}")
    if not (INT_MM_KERNELS and WEIGHT_COPY_KERNELS):
        raise AssertionError("int8_dynamic_gemm: no GEMM or copy kernel recorded")


# 4 batches of 1 x 512 synthetic ids (seed 0): at most 2,048 captured rows
PTQ_BATCHES = (4, 512)
PTQ_PROBE = 64  # tokens of the prompt whose fake-quant and compressed logits are compared
# The compressed model against its fake-quant self before ``compress`` on
# the same prompt (PERF.md derives both bars from CPU runs of this phase):
# each packed layer on the input it saw in the fake-quant forward, max
# |difference| over max |fake-quant output| (the two paths differ by the
# fake-quant weights' bf16 rounding and the kernels' f32 sums), and the
# logits, ||difference|| / ||fake-quant logits||, per (preset, depth): a
# random model's per-tensor int8 activations amplify the first layers'
# differences layer by layer, so the logit bar grows with depth.
PTQ_LAYER_BAR = 0.02
# NVFP4 activations: a random model's logits move chaotically with the
# weights' midpoint codes (see the per-layer check in ``quantize_on_card``);
# CPU runs of this phase at hidden 1024 gave 0.26 (SVDQuant), 0.34 (AWQ
# full) and 0.44 (rotated KV) at 4 layers and 0.35 (SVDQuant) at 8
PTQ_LOGIT_BAR = {("INT8_KV_CFG", 32): 0.8, ("INT8_KV_CFG", 16): 0.8,
                 ("W4A8_INT8KV_CFG", 4): 0.2,
                 ("INT4_AWQ_FULL_CFG", 4): 0.1,
                 ("NVFP4_SVDQUANT_CFG", 8): 0.8,
                 ("NVFP4_AWQ_FULL_CFG", 4): 0.8,
                 ("NVFP4_KV_ROTATE_CFG", 4): 0.8}


def with_outliers(bundle) -> None:
    """Channels 0-3 of every layer's two input RMSNorm scales at 30 (the
    channel outliers SmoothQuant moves into the weights), in place."""
    for layer in bundle.module.layers():
        for norm in (layer.input_norm, layer.post_attn_norm):
            norm.scale.data[:4] = 30.0


@contextlib.contextmanager
def step_times(torch, module, each: list = None):
    """Time an algorithm module's ``capture_inputs`` and ``max_calibrate``
    calls and, where the module has one (SVDQuant), its ``low_rank`` SVD
    (the card synchronized around each); yields {step: seconds}. ``each``
    receives every SVD call's (shape, seconds)."""
    attrs = {"capture": "capture_inputs", "calibration": "max_calibrate"}
    if hasattr(module, "low_rank"):
        attrs["svd"] = "low_rank"
    times = dict.fromkeys(attrs, 0.0)
    real = {step: getattr(module, attr) for step, attr in attrs.items()}

    def timed(step):
        def fn(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = real[step](*args, **kw)
            torch.cuda.synchronize()
            dt = time.time() - t0
            times[step] += dt
            if step == "svd" and each is not None:
                each.append((tuple(args[0].shape), dt))
            return out
        return fn

    for step, attr in attrs.items():
        setattr(module, attr, timed(step))
    try:
        yield times
    finally:
        for step, attr in attrs.items():
            setattr(module, attr, real[step])


def quantize_on_card(torch, cfg, preset) -> tuple:
    """Build ``cfg`` in full precision (``build_bundle``, seed 0) with
    channel outliers, ``quantize`` it under ``preset`` with its own
    algorithm on PTQ_BATCHES, take the QUANT-phase logits of a PTQ_PROBE-
    token prompt, ``compress``, check that every quantized kernel is gone,
    and hold the compressed model's logits on the same prompt to the
    fake-quant ones (PTQ_LOGIT_BAR, PTQ_ARGMAX_BAR). Logs each step's time,
    the peak memory and the compressed model's size. Returns the bundle and
    {step: seconds}."""
    from modelopt_tpu_torch.models.synthetic import build_bundle
    from modelopt_tpu_torch.quant.algorithms import awq, smoothquant, svdquant
    from modelopt_tpu_torch.quant.api import quantize
    from modelopt_tpu_torch.quant.compress import compress
    from modelopt_tpu_torch.quant.config import get_config
    from modelopt_tpu_torch.quant.fake_quant import is_two_level_fp
    from modelopt_tpu_torch.quant.qtensor import dequantize_qtensor, quantize_qtensor

    dev, times = "cuda", {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    bundle = build_bundle(cfg, seed=0, device=dev)
    with_outliers(bundle)
    torch.cuda.synchronize()
    times["build"] = time.time() - t0
    size = sum(t.numel() * t.element_size() for t in bundle.module.parameters())
    log(f"  built {cfg.num_layers} layers in full precision ({cfg.param_dtype}): "
        f"{size / 1e9:.2f} GB in {times['build']:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, T = PTQ_BATCHES
    batches = [torch.randint(1, cfg.vocab_size, (1, T), dtype=torch.int32, device=dev,
                             generator=gen) for _ in range(n)]
    method = get_config(preset).algorithm_name
    algorithm = {"smoothquant": smoothquant, "svdquant": svdquant}.get(method, awq)
    svds: list = []
    with step_times(torch, algorithm, svds) as steps:
        t0 = time.time()
        bundle = quantize(bundle, preset, lambda f: [f(ids) for ids in batches])
        torch.cuda.synchronize()
        total = time.time() - t0
    if method == "max":  # max calibration alone: one step
        times["calibration"] = total
    else:
        times.update(steps)
        times["search"] = total - sum(steps.values())
    if svds:
        log(f"  SVD (svdquant.low_rank: top-32 triplets by an f64 Gram eigensolve) per call: "
            + ", ".join(f"{'x'.join(map(str, shp))} {dt:.2f} s" for shp, dt in svds))
    peak = torch.cuda.max_memory_allocated()
    probe = torch.randint(1, cfg.vocab_size, (1, PTQ_PROBE), dtype=torch.int32, device=dev,
                          generator=gen)
    seen = {}  # packed layer: (its input, its fake-quant output) in the probe's forward
    hooks = [m.register_forward_hook(lambda m, i, o: seen.__setitem__(m, (i[0], o)))
             for m in bundle.module.modules() if type(m).__name__ == "QuantDense"
             and m.path != "lm_head"]
    fq = bundle.apply(probe)[0].float()
    for h in hooks:
        h.remove()
    # NVFP4 weights: the packing rounds an exact midpoint of the e2m1 grid
    # down (the reference's ``sum(|x| > midpoints)``) where fake
    # quantization rounds it to even, and takes each kernel's own
    # per-tensor amax where the weight quantizer may hold a larger one
    # (NVFP4_AWQ_FULL_CFG: awq_clip clips after awq_lite's max calibration,
    # whose running max keeps the pre-clip amax, as the reference's does).
    # So an NVFP4 layer's fake-quant self is taken again with the packed
    # grid's weights (the logits keep the calibrated fake-quant model's)
    moved = stale = n_w = 0
    with bundle.contexts(), torch.no_grad():
        nvfp4 = [m for m in seen if (m.weight_quantizer.specs() or ())
                 and is_two_level_fp(m.weight_quantizer.specs()[0])]
        for m in nvfp4:
            spec, kernel = m.weight_quantizer.specs()[0], m.kernel
            w_pk = dequantize_qtensor(quantize_qtensor(kernel, spec)[0], spec,
                                      tuple(kernel.shape)).to(kernel.dtype)
            moved += int((m.weight_quantizer(kernel) != w_pk).sum())
            stale += not torch.equal(m.weight_quantizer.amax, kernel.float().abs().amax())
            n_w += kernel.numel()
            m.weight_quantizer.forward = lambda *a, w=w_pk, **k: w
            seen[m] = (seen[m][0], m(seen[m][0]))
            del m.weight_quantizer.forward, w_pk
        if nvfp4:
            # the card's packing of one full-width layer, bit for bit
            # against the CPU's packing of the same kernel
            m0 = nvfp4[0]
            cpu_qt = quantize_qtensor(m0.kernel.cpu(), m0.weight_quantizer.specs()[0])[0]
    if nvfp4:
        log(f"  NVFP4 weights: {moved} of {n_w} elements ({moved / n_w:.3%}) differ between the "
            f"calibrated fake quantization and the packed grid (exact midpoints, and "
            f"{stale} of {len(nvfp4)} weight quantizers holding a per-tensor amax other "
            f"than their kernel's); each layer's fake-quant self taken on the packed grid")
    torch.cuda.synchronize()
    t0 = time.time()
    bundle = compress(bundle)
    torch.cuda.synchronize()
    times["compress"] = time.time() - t0
    packed = bundle.records[-1].metadata["compressed"]
    dense = [m.path for m in bundle.module.modules() if getattr(m, "kernel", None) is not None]
    if len(packed) != 4 * cfg.num_layers or dense != ["lm_head"]:
        raise AssertionError(f"compress: packed {len(packed)}, dense kernels left {dense}")
    size_c = sum(t.numel() * t.element_size() for t in
                 list(bundle.module.parameters()) + list(bundle.module.buffers()))
    if nvfp4:
        differ = [k for k, v in cpu_qt.items() if not torch.equal(
            m0.qweight[k].cpu().view(torch.uint8), v.view(torch.uint8))]
        log(f"  packed NVFP4 bytes of {m0.path} ({m0.in_features}x{m0.features}): card against "
            f"the CPU's quantize_qtensor of the same kernel, {sorted(cpu_qt)} "
            + (f"differ in {differ}" if differ else "bit-identical"))
        if differ or sorted(cpu_qt) != sorted(m0.qweight):
            raise AssertionError(f"{preset}: the card packs {m0.path} otherwise than the CPU")
        del cpu_qt
    layer_err = {}
    with bundle.contexts(), torch.no_grad():
        for m, (x, y) in seen.items():
            layer_err[m.path] = ((m(x).float() - y.float()).abs().max()
                                 / y.float().abs().max()).item()
    worst = max(layer_err, key=layer_err.get)
    got = bundle.apply(probe)[0].float()
    err = ((got - fq).norm() / fq.norm()).item()
    agree = (got.argmax(-1) == fq.argmax(-1)).float().mean().item()
    bar = PTQ_LOGIT_BAR[(preset, cfg.num_layers)]
    log(f"  {preset}: " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
        + f"; peak memory {peak / 2**30:.2f} GiB through quantize; compressed model "
        f"{size_c / 1e9:.2f} GB ({len(packed)} layers packed, the bf16 kernels dropped)")
    log(f"  compressed vs fake-quant on a {PTQ_PROBE}-token prompt: each packed layer on its "
        f"fake-quant input, max |diff| / max |output| <= {layer_err[worst]:.4f} ({worst}; "
        f"bar {PTQ_LAYER_BAR}); logits ||diff|| / ||logits|| {err:.4f} (bar {bar}), max "
        f"|diff| / max |logit| {(got - fq).abs().max().item() / fq.abs().max().item():.4f}, "
        f"argmax agreement {agree:.3f}")
    if not (len(layer_err) == len(packed) and layer_err[worst] <= PTQ_LAYER_BAR
            and torch.isfinite(got).all() and err <= bar):
        raise AssertionError(f"{preset}: the compressed model is off its fake-quant self")
    return bundle, times


def act_quant_census(torch, bundle, cfg) -> dict:
    """What the NVFP4 activation fake-quant adds to a decode forward: the
    compressed ``bundle`` over a fresh bf16 cache of 8 slots, 40 tokens
    prefilled, then two decode forwards, the second profiled (the first
    warms the profiler up), once as quantized and once with every input
    quantizer disabled (``disable_quantizer``; the SVD branch, K9 and the
    attention unchanged). Logs host launch calls and device kernel records
    of each, and their difference, the fake-quant's; returns
    {"quantized": (calls, records), "inputs raw": (calls, records)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from modelopt_tpu_torch.models import make_cache
    from modelopt_tpu_torch.quant.api import disable_quantizer

    ids = torch.randint(1, cfg.vocab_size, (8, 42), dtype=torch.int32, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    out = {}
    for what, b in (("quantized", bundle),
                    ("inputs raw", disable_quantizer(bundle, "*input_quantizer"))):
        cache = make_cache(cfg, 8, 64, dtype=torch.bfloat16, device="cuda")
        _, cache = b.apply(ids[:, :40], cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for i in range(2):
                _, cache = b.apply(ids[:, 40 + i:41 + i], cache)
                torch.cuda.synchronize()
                prof.step()
        events = prof.key_averages()
        calls = sum(ev.count for ev in events if ev.device_type == DeviceType.CPU
                    and any(k in ev.key for k in ("Launch", "Memcpy", "Memset")))
        records = sum(ev.count for ev in events if ev.device_type == DeviceType.CUDA
                      and not ev.key.startswith("ProfilerStep"))
        out[what] = (calls, records)
        del cache
    (c1, r1), (c0, r0) = out["quantized"], out["inputs raw"]
    n_q = 4 * cfg.num_layers
    log(f"  census, one decode forward of {cfg.num_layers} layers (8 slots): {c1} host launch "
        f"calls, {r1} device kernel records; with the input quantizers off {c0} / {r0}: the "
        f"NVFP4 activation fake-quant adds {c1 - c0} launch calls and {r1 - r0} device kernels "
        f"({(r1 - r0) / n_q:.1f} per quantized projection input, {n_q} a forward)")
    if r1 <= r0:
        raise AssertionError("census: the NVFP4 activation fake-quant launched nothing")
    return out


def ptq_path(torch, name: str = "M") -> dict:
    """Paths M and S: Llama-3-8B at full width (``PATH_LAYERS``' depth)
    built in bf16 on the card, quantized by its preset's own algorithm (M:
    INT8_KV_CFG, SmoothQuant over the captured inputs, then max calibration
    of the per-channel weights, the static activations and the int8 KV
    cache; S: NVFP4_SVDQUANT_CFG, SVDQuant's smoothing and rank-32 branch
    on every projection, then max calibration of the NVFP4 weights' and
    activations' per-tensor amax), compressed, then served as
    ``serve_bundle`` serves the other paths. On S the launch counters are
    also zeroed just before the quantize step and read just after it, and
    those launches are checked against PATH_KERNELS["S-quantize"] on their
    own; S also takes ``act_quant_census``. Returns {path: launches}: the
    served run's under ``name``, and on S the quantize step's under
    "S-quantize"."""
    from modelopt_tpu_torch import kernels

    title, model, preset, _ = PATHS[name]
    cfg = path_config(torch, model, PATH_LAYERS.get(name))
    kernels.reset_launch_counts()
    bundle, _ = quantize_on_card(torch, cfg, preset)
    torch.cuda.synchronize()
    quantize_launches = kernels.launch_counts()
    if name != "S":
        return {name: serve_bundle(torch, name, bundle, cfg)}
    log(f"  launches in the quantize step: {quantize_launches}")
    step = "S-quantize"
    missing = [k for k in PATH_KERNELS[step] if quantize_launches[k] <= 0]
    strays = [k for k, n in quantize_launches.items() if n and k not in PATH_KERNELS[step]]
    if missing or strays:
        raise AssertionError(f"path S quantize step: never launched {missing}, launched "
                             f"{strays}")
    act_quant_census(torch, bundle, cfg)
    return {name: serve_bundle(torch, name, bundle, cfg), step: quantize_launches}


PTQ_LAYERS = 4  # of Llama-3-8B's 32, at full width
PTQ_PRESETS = (("W4A8_INT8KV_CFG", "int8"), ("INT4_AWQ_FULL_CFG", "bfloat16"),
               ("NVFP4_AWQ_FULL_CFG", "bfloat16"), ("NVFP4_KV_ROTATE_CFG", "bfloat16"))


def ptq_phase(torch) -> dict:
    """The AWQ family and a rotated NVFP4 KV preset on the card: Llama-3-8B
    at full width, PTQ_LAYERS layers, under W4A8_INT8KV_CFG (awq_lite, then
    K1 serving), INT4_AWQ_FULL_CFG (awq_lite then awq_clip, then K6
    serving), NVFP4_AWQ_FULL_CFG (awq_lite then awq_clip on NVFP4 weights,
    NVFP4 activations, then K9 serving) and NVFP4_KV_ROTATE_CFG (max
    calibration; q / k / v fake-quantized to NVFP4 in the Hadamard basis
    into a bf16 cache, K9 serving): quantize, compress and compare
    (``quantize_on_card``), log each group's chosen exponent and the clip
    ratios, then serve one request of TRAFFIC's prompt length. Launch
    counters are zeroed before the first quantize and read after the last
    request; returns them."""
    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.serve import ServingEngine

    cfg = path_config(torch, "llama3_8b", PTQ_LAYERS)
    kernels.reset_launch_counts()
    for preset, kv in PTQ_PRESETS:
        log(f"  {preset} at {PTQ_LAYERS} layers")
        bundle, _ = quantize_on_card(torch, cfg, preset)
        if "awq_lite" in bundle.metadata:
            alphas = {p: round(v["alpha"], 2) for p, v in bundle.metadata["awq_lite"].items()}
            log(f"  awq_lite exponents: {json.dumps(alphas)}")
        if "awq_clip" in bundle.metadata:
            total: dict = {}
            for hist in bundle.metadata["awq_clip"].values():
                for r, c in hist.items():
                    total[r] = total.get(r, 0) + c
            log(f"  awq_clip ratios chosen (count of blocks x columns): {json.dumps(total)}")
        eng = ServingEngine(bundle, max_batch=1, max_seq_len=2176, prefill_buckets=(32, 544),
                            kv_dtype=getattr(torch, kv), multi_step=16, max_admit=1,
                            device="cuda")
        prompt = torch.randint(1, cfg.vocab_size, (TRAFFIC[1],),
                               generator=torch.Generator().manual_seed(3)).tolist()
        req = eng.submit(prompt, max_new_tokens=16)
        eng.run()
        lps = torch.tensor(req.out_logprobs)
        if not (len(req.out_tokens) == 16 and torch.isfinite(lps).all()):
            raise AssertionError(f"{preset}: bad served request {req.out_tokens}")
        log(f"  served one request of {TRAFFIC[1]} -> 16 tokens, {kv} cache")
        del eng, bundle
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  launches in the PTQ phase: {launches}")
    missing = [k for k in PATH_KERNELS["PTQ"] if launches[k] <= 0]
    strays = [k for k in launches if k not in PATH_KERNELS["PTQ"] and launches[k]]
    if missing or strays:
        raise AssertionError(f"PTQ phase: never launched {missing}, launched {strays}")
    return launches


PTQ_FLOOR_DRAWS = 4
PTQ_PARITY_PRESETS = ("INT8_KV_CFG", "W4A8_INT8KV_CFG", "NVFP4_SVDQUANT_CFG")
# SVDQuant on both devices: each layer's low-rank product svd_lora_a @
# svd_lora_b and residual kernel, max |card - CPU| over max |CPU| (the f64
# Gram eigensolve by cuSOLVER against LAPACK, on smoothed kernels that
# differ by the scales' last bits), on weights whose top-32 singular values
# stand at least SVD_GAP above the 33rd (``plant_low_rank``), where the
# truncation is well posed
SVD_PARITY_BAR = 1e-3
SVD_GAP = 2.0


def plant_low_rank(torch, bundle, rank: int = 32, seed: int = 3) -> None:
    """Add to every projection kernel [in, out] of ``bundle`` (in place) a
    rank-``rank`` part U diag(sigma) V^T, orthonormal U and V drawn from
    ``seed``, sigma from 20 down to 10 times the kernel's own largest
    singular value: the outlier part SVDQuant takes into its branch, with
    a clear gap after it even once the channel outliers' smoothing scales
    (a range of ~10) have reshaped the spectrum. The sum is scaled back to
    the kernel's own largest singular value: at full strength the attention
    is so peaked that the f32 sums' order moved a later layer's channel
    maxima, and so its pre-quant scale, 3.55e-4 apart between card and CPU
    (past the parity's 1e-4 bar)."""
    g = torch.Generator().manual_seed(seed)
    for m in bundle.module.modules():
        if type(m).__name__ != "QuantDense" or m.path == "lm_head":
            continue
        w = m.kernel.data
        u = torch.linalg.qr(torch.randn(w.shape[0], rank, generator=g))[0]
        v = torch.linalg.qr(torch.randn(w.shape[1], rank, generator=g))[0]
        norm = torch.linalg.matrix_norm(w.float(), ord=2)
        w += ((u * (torch.linspace(20.0, 10.0, rank) * norm)) @ v.T).to(w.dtype)
        w *= norm / torch.linalg.matrix_norm(w.float(), ord=2)


def ptq_parity(torch) -> None:
    """A tiny f32 llama (hidden 1024, 2 layers, D = 128) drawn on the CPU
    (``build_bundle``, channel outliers) and copied to the card, quantized
    by the port on both devices with the same ids under INT8_KV_CFG
    (SmoothQuant), W4A8_INT8KV_CFG (awq_lite) and NVFP4_SVDQUANT_CFG
    (SVDQuant, on weights with a planted rank-32 part, ``plant_low_rank``;
    NVFP4 activations): the same awq_lite
    exponents (or, where they differ, losses within 1e-5 relative), under
    SVDQuant each layer's low-rank product and residual within
    SVD_PARITY_BAR (the spectral gap of every CPU-smoothed kernel checked
    to be at least SVD_GAP first), the
    same pre-quant scales and calibrated amax (the first projection's,
    layer 0's qkv_proj, whose input is the same up to the embedding's norm,
    to rtol 1e-5; the others', whose inputs come through f32 GEMMs summed
    in another order, to rtol 1e-4); then, from the card's calibrated
    state copied back to the CPU, both devices' compressed logits on a
    probe within 3% of the largest CPU logit plus the CPU's noise floor
    (the FP8 parity's rule, ``_parity(noise_floor=True)``, with the sums
    moved by the kernels' own order bar, K * 2^-24, the largest change of
    PTQ_FLOOR_DRAWS draws: static int8
    activations with channel outliers round a projection's input to a
    coarse grid, so a last-bit change moves a code by a whole step, which
    the layers amplify). So that the floor hides no fault, every fake-quant
    call of the CPU run is repeated on the card, bit for bit, and each
    packed layer is run on the card on the input the CPU's layer saw,
    within 1e-3 of its largest output (f32 outputs: the kernels' sums in
    another order). The CPU's own calibration is not used
    for the logits: a grid an ulp apart flips codes too."""
    import copy

    from modelopt_tpu_torch.core.bundle import ModelBundle
    from modelopt_tpu_torch.models import llama_config
    from modelopt_tpu_torch.models.synthetic import build_bundle
    from modelopt_tpu_torch.quant.api import quantize
    from modelopt_tpu_torch.quant.compress import compress

    cfg = llama_config(vocab_size=4096, hidden_size=1024, num_layers=2, num_heads=8,
                       num_kv_heads=2, intermediate_size=2048, max_position_embeddings=256,
                       rope_theta=500000.0, fused_qkv=True, fused_gate_up=True,
                       dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    calib = torch.randint(1, cfg.vocab_size, (2, 64), dtype=torch.int32, generator=g)
    probe = torch.randint(1, cfg.vocab_size, (2, 32), dtype=torch.int32, generator=g)
    for preset in PTQ_PARITY_PRESETS:
        cpu = build_bundle(cfg, seed=0, init_scale=0.05, device="cpu")
        with_outliers(cpu)
        if preset == "NVFP4_SVDQUANT_CFG":
            plant_low_rank(torch, cpu)
        gpu = ModelBundle(module=copy.deepcopy(cpu.module).to("cuda"))
        out = {}
        for dev, b in (("cpu", cpu), ("cuda", gpu)):
            ids = calib.to(dev)
            b = quantize(b, preset, lambda f: f(ids))
            state = {(m.path, k): getattr(m, k).float().cpu() for m in b.module.modules()
                     for k in ("pre_quant_scale", "amax") if getattr(m, k, None) is not None}
            # SVDQuant's branch: the low-rank product and the residual kernel
            svd = {m.path: ((m.svd_lora_a @ m.svd_lora_b).cpu(), m.kernel.float().cpu(),
                            (1.0 / m.input_quantizer.pre_quant_scale).cpu())
                   for m in b.module.modules() if getattr(m, "svd_lora_a", None) is not None}
            out[dev] = (b, b.metadata.get("awq_lite", {}), state, svd)
        (_, aw_c, st_c, svd_c), (gpu, aw_g, st_g, svd_g) = out["cpu"], out["cuda"]
        svd_err, gaps = {}, []
        for p, (lr, res, sm) in svd_c.items():
            # the CPU's smoothed kernel W' = R + diag(s) svd_lora_a svd_lora_b
            sv = torch.linalg.svdvals((res + sm[:, None] * lr).double())
            gaps.append((sv[31] / sv[32]).item())
            svd_err[p] = max(((svd_g[p][i] - t).abs().max() / t.abs().max()).item()
                             for i, t in enumerate((lr, res)))
        if preset == "NVFP4_SVDQUANT_CFG":
            worst_svd = max(svd_err, key=svd_err.get)
            log(f"  ptq {preset}: {len(svd_err)} layers with a rank-32 branch on both devices; "
                f"smallest spectral gap sigma_32 / sigma_33 {min(gaps):.2f} (at least {SVD_GAP}); "
                f"card against CPU, low-rank product and residual within "
                f"{svd_err[worst_svd]:.3g} of their largest value ({worst_svd}; bar "
                f"{SVD_PARITY_BAR})")
            if (sorted(svd_g) != sorted(svd_c) or len(svd_c) != 4 * cfg.num_layers
                    or min(gaps) < SVD_GAP or svd_err[worst_svd] > SVD_PARITY_BAR):
                raise AssertionError(f"ptq parity {preset}: SVD branch {svd_err}, gaps {gaps}")

        def back():  # the card's calibrated state, compressed on the CPU
            b = ModelBundle(module=copy.deepcopy(gpu.module).to("cpu"), records=gpu.records)
            return compress(b)

        cpu_c = back()
        fq_trace = _fake_quant_trace(cpu_c)
        seen = {}  # packed layer path: (its input, its output) in the CPU's forward
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.__setitem__(m.path, (i[0].clone(), o.clone())))
            for m in cpu_c.module.modules() if getattr(m, "compressed", False)]
        ref = cpu_c.apply(probe)[0].float()
        for h in hooks:
            h.remove()
        # the noise floor: the CPU run again with its GEMMs' f32 sums moved by
        # the kernels' own order bar, K * 2^-24 at K = 2048, the largest
        # change of PTQ_FLOOR_DRAWS draws
        floor = 0.0
        for seed in range(PTQ_FLOOR_DRAWS):
            with _perturbed_sums(torch, 2048 * 2.0**-24, seed):
                floor = max(floor, (back().apply(probe)[0].float() - ref).abs().max().item())
        gpu = compress(gpu)
        _replay_fake_quant(torch, f"ptq {preset}", fq_trace, gpu)
        mods = {m.path: m for m in gpu.module.modules()}
        with gpu.contexts(), torch.no_grad():
            layer_err = max(((mods[p](x.to("cuda")).float().cpu() - y.float()).abs().max()
                             / y.float().abs().max()).item() for p, (x, y) in seen.items())
        got = gpu.apply(probe.to("cuda"))[0].float().cpu()
        if sorted(st_c) != sorted(st_g) or not any(k == "pre_quant_scale" for _, k in st_c):
            raise AssertionError(f"ptq parity {preset}: calibrated state on other layers")
        flips = []
        for p in aw_c:
            a, b = aw_c[p], aw_g[p]
            if a["alpha"] != b["alpha"]:
                rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
                flips.append((p, a["alpha"], b["alpha"], rel))
                if rel > 1e-5:
                    raise AssertionError(f"ptq parity {preset}: {p} exponent {a['alpha']} on "
                                         f"the CPU, {b['alpha']} on the card, losses {rel}")
        rel = {key: ((st_g[key] - st_c[key]).abs() / st_c[key].abs()).max().item()
               for key in st_c}
        worst = {}  # (the first projection or not, buffer) -> largest relative difference
        for (path, k), r in rel.items():
            key = (path.startswith("layers_0/attn/qkv_proj/"), k)
            worst[key] = max(worst.get(key, 0.0), r)
        loss_err = max((max(abs(x - y) / abs(x) for x, y in zip(aw_c[p]["losses"],
                                                                 aw_g[p]["losses"]))
                        for p in aw_c), default=0.0)
        err = (got - ref).abs().max().item()
        tol = 3e-2 * ref.abs().max().item() + floor
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"  ptq {preset}: exponents {[round(v['alpha'], 2) for v in aw_c.values()]} on both"
            + (f" but {flips}" if flips else "") + f", awq losses within {loss_err:.3g} "
            "relative; card against CPU, largest relative difference: "
            + ", ".join(f"{'first projection' if first else 'the rest'} {k} {r:.3g}"
                        for (first, k), r in sorted(worst.items()))
            + f"; from the card's state, each of {len(seen)} packed layers on the CPU's "
            f"input within {layer_err:.3g} of its largest output (bar 1e-3), compressed "
            f"logits max |diff| {err:.4g} (tol {tol:.4g}, of which the CPU's noise floor "
            f"{floor:.4g}), argmax agreement {agree:.3f}")
        bad = [key for key, r in worst.items() if r > (1e-5 if key[0] else 1e-4)]
        if bad or not (layer_err <= 1e-3 and err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"ptq parity {preset}: state {bad}, layers {layer_err}, "
                                 f"logits {err}")


def measured_run(torch, eng, name) -> dict:
    """Serve TRAFFIC with the launch counters zeroed just before and read
    just after; check that every request got its tokens, that every kernel
    of the path launched and that the other preset's kernels did not.
    Returns the counts."""
    from modelopt_tpu_torch import kernels
    from modelopt_tpu_torch.serve import run_serving_benchmark

    n_req, in_len, out_len = TRAFFIC
    torch.cuda.reset_peak_memory_stats()
    eng.stats = dict.fromkeys(eng.stats, 0)  # count the measured run only
    kernels.reset_launch_counts()
    rep = run_serving_benchmark(eng, n_requests=n_req, input_len=in_len,
                                output_len=out_len, vocab=eng.cfg.vocab_size, seed=1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  {n_req} requests x {in_len} prompt -> {out_len} new tokens: output "
        f"{rep['output_tok_s']:.1f} tok/s, TTFT first {rep['ttft_first_s']:.3f} s "
        f"mean {rep['ttft_mean_s']:.3f} s, decode {rep['decode_tok_s']:.1f} tok/s, "
        f"total {rep['total_s']:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  engine stats {rep['engine_stats']}")
    log(f"  launches on path {name}: {launches}")
    if rep["output_tokens"] != n_req * out_len:
        raise AssertionError(f"path {name}: {rep['output_tokens']} tokens, "
                             f"expected {n_req} x {out_len}")
    missing = [k for k in PATH_KERNELS[name] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"path {name} never launched {missing}")
    strays = [k for k in launches if k not in PATH_KERNELS[name] and launches[k]]
    if strays:
        raise AssertionError(f"path {name} launched {strays}, kernels of another path")
    # one KV-write launch a layer: every forward writes through K16 (paged)
    # or K3 (MLA's dense latent cache); an MHA dense cache's prefill chunks
    # through K3 (K2 writes its decode steps)
    stats, layers = rep["engine_stats"], eng.cfg.num_layers
    forwards = stats["prefill_chunks"] + stats["decode_forwards"]
    write = "paged_kv_write" if eng.paged else "dense_kv_write"
    want = layers * (forwards if eng.paged or eng.cfg.attention_type == "mla"
                     else stats["prefill_chunks"])
    if launches[write] != want:
        raise AssertionError(f"path {name}: {launches[write]} {write} launches, want one a "
                             f"layer: {want}")
    return launches


def check_output(torch, eng, vocab_size) -> None:
    """One more request: 16 tokens in the vocabulary, finite log-probs <= 0."""
    req = eng.submit(list(range(1, 200)), max_new_tokens=16)
    eng.run()
    lps = torch.tensor(req.out_logprobs)
    if not (len(req.out_tokens) == 16 and all(0 <= t < vocab_size for t in req.out_tokens)
            and torch.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError(f"bad output {req.out_tokens} {req.out_logprobs}")


def profile_window(torch, eng, n_req: int, in_len: int, out_len: int, vocab: int) -> None:
    """torch.profiler over a short window of decode ticks (n_req fresh
    prompts of in_len tokens, prefilled before the window opens, out_len new
    tokens each), reported by ``report_profile``."""
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator().manual_seed(7)
    reqs = [eng.submit(torch.randint(1, vocab, (in_len,), generator=rng).tolist(),
                       max_new_tokens=out_len) for _ in range(n_req)]
    while not all(r.out_tokens for r in reqs):  # prefills first
        eng.step()
    torch.cuda.synchronize()
    forwards = eng.stats["decode_forwards"], eng.stats["prefill_chunks"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    report_profile(torch, prof, wall,
                   f"{n_req} requests x {in_len} -> {out_len} tokens, decode ticks only; "
                   f"{eng.stats['decode_forwards'] - forwards[0]} decode forwards, "
                   f"{eng.stats['prefill_chunks'] - forwards[1]} prefill chunks")


def context_window(torch, eng, n_req: int, in_len: int, vocab: int) -> None:
    """torch.profiler over one scheduler tick, a burst of the engine's
    multi_step decode forwards, with every slot at ~in_len keys: n_req
    prompts of in_len tokens are prefilled first (a slot decodes one token a
    tick while the others prefill, and the tick that ends the last prefill
    bursts once: the first slot holds ~24 tokens, the last 17), 48 new
    tokens each, so no slot finishes before the profiled burst does and a
    paged slot needs at most 17 pages of 64 rows; the requests finish
    outside the window."""
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator().manual_seed(9)
    reqs = [eng.submit(torch.randint(1, vocab, (in_len,), generator=rng).tolist(),
                       max_new_tokens=48) for _ in range(n_req)]
    while not all(r.out_tokens for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    forwards = eng.stats["decode_forwards"]
    keys = [in_len + len(r.out_tokens) for r in reqs]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    active = sum(not r.done for r in reqs)
    report_profile(torch, prof, wall,
                   f"{n_req} requests at {min(keys)}-{max(keys)} keys, one tick; "
                   f"{eng.stats['decode_forwards'] - forwards} decode forwards, {active} "
                   f"requests still running after it")
    eng.run()


# the GEMM kernels torch._int_mm runs for int8_dynamic_gemm at a 544-row
# chunk of each Llama projection, and the kernel of the weight's K-major
# copy, by name (filled by ``int8_dynamic_rows`` in the kernel phase, read
# by path M's prefill window; other strided copies share the copy's name)
INT_MM_KERNELS: list = []
WEIGHT_COPY_KERNELS: list = []
# the kernels a prefill window reports apart, by path: (label, kernel names)
PREFILL_SPLIT = {
    "A": (("K1", ("w4a8_dec_kernel", "w4a8_wg_kernel")),
          ("K3", ("kv_write_kernel",)), ("K4", ("flash_prefill_kernel",))),
    # K6 and K10 share their kernels: "K6" is both (K10 takes the MoE's down
    # projection in the 32-row bucket only)
    "C": (("K6", ("w4a16_dec_kernel", "w4a16_wg_kernel")), ("K3", ("kv_write_kernel",)),
          ("K4", ("flash_prefill_kernel",))),
    # the 544-row chunks' projections: int8_dynamic_gemm's s8 x s8 product
    # and its K-major weight copies (the kernels of the kernel phase's rows)
    "M": (("int8 GEMM", INT_MM_KERNELS), ("strided copies", WEIGHT_COPY_KERNELS),
          ("K7", ("w8_dec_kernel", "w8_wg_kernel")), ("K3", ("kv_write_kernel",)),
          ("K4", ("flash_prefill_kernel",))),
}


def prefill_window(torch, bundle, cfg, kv_dtype, path: str = "A") -> None:
    """One prompt of TRAFFIC's length prefilled alone into a one-slot cache
    of the engine's width, as the engine streams it (544-row chunks, the
    last padded with zeros, logits at its last true token; no decode tick),
    once unprofiled and once under torch.profiler: the wall time to the
    first token's logits and the device busy time by kernel, the path's
    kernels of ``PREFILL_SPLIT`` and the rest (paths A's and C's prefill
    rows)."""
    from torch.profiler import ProfilerActivity, profile

    from modelopt_tpu_torch.models import make_cache

    n, bucket, dev = TRAFFIC[1], 544, "cuda"
    rng = torch.Generator().manual_seed(11)
    cache = make_cache(cfg, 1, 2176, kv_dtype, device=dev)

    def prefill():
        prompt = torch.randint(1, cfg.vocab_size, (n,), dtype=torch.int32, generator=rng)
        for lo in range(0, n, bucket):
            chunk = prompt[lo:lo + bucket]
            ids = torch.zeros(1, bucket, dtype=torch.int32)
            ids[0, :len(chunk)] = chunk
            sub = {"k": cache["k"], "v": cache["v"],
                   "lengths": torch.full((1,), lo, dtype=torch.int32, device=dev)}
            logits, _ = bundle.apply(ids.to(dev), sub,
                                     logits_index=torch.full((1,), len(chunk) - 1, device=dev))
        torch.cuda.synchronize()
        return logits

    walls = []
    for _ in range(2):
        t0 = time.time()
        logits = prefill()
        walls.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        logits = prefill()
        wall = time.time() - t0
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill window: logits not finite")
    by_name = report_profile(torch, prof, wall, f"one {n}-token prompt to its first token's "
                             f"logits, {-(-n // bucket)} chunks of {bucket}")
    split = {k: sum(v for name, v in by_name.items() if any(key in name for key in keys))
             for k, keys in PREFILL_SPLIT[path]}
    busy = sum(by_name.values())
    log(f"  prefill row (path {path}): wall {walls[0] * 1e3:.1f} / {walls[1] * 1e3:.1f} ms unprofiled, "
        f"{wall * 1e3:.1f} ms profiled; device busy {busy:.2f} ms: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f", rest {busy - sum(split.values()):.2f}")


def report_profile(torch, prof, wall: float, what: str) -> dict:
    """Log a profile window: device time by kernel, kernel launches, device
    busy time against the wall clock (the idle share is an upper bound: the
    profiler's own host cost lengthens the wall). Returns the device ms by
    kernel name."""
    from torch.autograd import DeviceType

    by_name = {}
    n_launch = 0
    for ev in prof.key_averages():
        # device-side events only: a host op's self device time repeats the
        # time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
            n_launch += ev.count
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(v for n, v in by_name.items() if k in n) for k in (
        "w4a8_dec_kernel", "w4a8_wg_kernel", "w4a16_dec_kernel", "w4a16_wg_kernel",
        "w4a16_straddle_kernel", "w4a16_wgs_kernel", "grouped_w4a8_combine_kernel",
        "fused_decode_kernel",
        "flash_prefill_kernel", "kv_write_kernel", "decode_attention_kernel",
        "paged_attention_kernel", "paged_cluster_kernel", "latent_cluster_kernel",
        "page_write_kernel", "w8_dec_kernel", "w8_wg_kernel",
        "nvfp4_dec_kernel", "nvfp4_wg_kernel", "block_sparse_attention_kernel",
        "sparse_cluster_kernel", "flash_attention_kernel", "grouped_w4a8_kernel")}
    log(f"  profile window ({what}): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms in {n_launch} kernels"
        + (f", idle share <= {1 - busy / (wall * 1e3):.3f}" if busy else
           " (no device time recorded: not measured)"))
    for name, ms in top:
        log(f"    {ms:9.2f} ms  {name[:90]}")
    log(f"    port kernels (ms): {json.dumps({k: round(v, 3) for k, v in ours.items()})}")
    return by_name


# sources whose ptxas lines are reported per template instance: the
# tensor-core tiles (flash, K1's, K6's, K7 / K8's and K9's wgmma tiles,
# K1's, K6's and K7 / K8's cluster decode tiles, K11 / K12's tiles on K1's
# decode tile), K2's cluster kernel and
# K15's and K17's (decode_attention.cu, beside the one-CTA instances of K5,
# K15 and K17)
PTXAS_BY_INSTANCE = ("flash_attention", "flash_prefill_attention", "fused_decode_attention",
                     "w4a8_gemm", "w4a16_gemm", "decode_attention", "nvfp4_gemm", "w8a16_gemm",
                     "grouped_w4a8_gemm")
# sources none of whose instances may spill registers, and kernels (by
# name, in any source) none of whose instances may: K1's decode tile, K17's
# cluster kernel, K12's and K11's 8-token instances (the decode steps') and
# K5 / K15's latent cluster kernel (its int8 and its e4m3 instances:
# latent_cluster_kernel<DJ, false> and <DJ, true>)
NO_SPILL = ("w4a16_gemm", "nvfp4_gemm", "w8a16_gemm")
NO_SPILL_KERNELS = ("w4a8_dec_kernel", "sparse_cluster_kernel", "grouped_w4a8_combine_kernel<1,",
                    "grouped_w4a8_kernel<1,", "latent_cluster_kernel",
                    # K6 / K10's straddle tiles, K9 / K13's tail instances
                    "w4a16_straddle_kernel", "w4a16_wgs_kernel", "nvfp4_dec_kernel<1, 1, true>",
                    "nvfp4_dec_kernel<2, 1, true>", "nvfp4_dec_kernel<1, 2, true>",
                    "nvfp4_wg_kernel<64, true>", "nvfp4_wg_kernel<128, true>")


def ptxas_by_function(text: str) -> dict:
    """nvcc -Xptxas -v output as {kernel: [its register, spill and static
    shared-memory lines]}, each kernel named by its template instance where
    c++filt can demangle it."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out.setdefault(fn, [])
        elif "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
            out.setdefault(fn, [])
        elif fn is not None and ("registers" in line or "spill" in line or "smem" in line):
            out[fn].append(line.strip().removeprefix("ptxas info    : "))
    from torch.utils.cpp_extension import CUDA_HOME

    for tool in ("c++filt", os.path.join(CUDA_HOME or "", "bin", "cu++filt")):
        try:
            plain = subprocess.run([tool], input="\n".join(out), capture_output=True, text=True,
                                   check=True).stdout.splitlines()
        except (OSError, subprocess.CalledProcessError):
            continue
        if len(plain) == len(out):
            break
    else:
        return out
    # the kernel's name (with its template arguments) just before its
    # parameter list, else its first word
    short = [m.group(1) if (m := re.search(r"(\w+(?:<[^>]*>)?)\(", p))
             else re.search(r"\w+", p).group(0) for p in plain]
    return dict(zip(short, out.values()))


# --------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from modelopt_tpu_torch.kernels import _build

    t_start = time.time()
    # full-f32 products: a TF32 router product could flip a top-8 expert
    # choice and change tokens
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; TF32 off (matmul and cuDNN)")
    t0 = time.time()
    _build.build_all()
    log(f"kernel build {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():  # e.g. C7518, a wgmma ptxas serialized
            if "warning" in line.lower():
                log(f"  ptxas {name} warning: {line.strip()}")
        if name in PTXAS_BY_INSTANCE:
            for fn, lines in ptxas_by_function(text).items():
                log(f"  ptxas {name} {fn}: {' | '.join(lines)}")
                no_spill = name in NO_SPILL or any(k in fn for k in NO_SPILL_KERNELS)
                if no_spill and any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines):
                    raise AssertionError(f"ptxas: {name} {fn} spills registers")
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log("  flash tiles' dynamic shared memory (csrc/flash_tile.cuh smem_bytes): "
        + ", ".join(f"D={d} {(64 * d + 4 * 64 * d) * 2} bytes" for d in (64, 128)))

    results: dict = {}
    kernel_phase(torch, results)
    dynamic: dict = {}
    int8_dynamic_rows(torch, torch.Generator(device="cuda").manual_seed(5), Timer(torch),
                      dynamic)
    log(f"census: a paged decode forward's launches ({time.time() - t_start:.0f} s)")
    write_census(torch)
    log(f"parity: small models, card against CPU ({time.time() - t_start:.0f} s)")
    parity_phase(torch)
    log(f"gateless QuantEinsum: K11's entry point ({time.time() - t_start:.0f} s)")
    by_path = {"gateless": gateless_phase(torch)}
    for name in PATHS:
        log(f"path {name}: {PATHS[name][0]}, ServingEngine ({time.time() - t_start:.0f} s)")
        if name in PTQ_PATHS:
            by_path.update(ptq_path(torch, name))
        else:
            by_path[name] = serve_path(torch, name)
    for name, (title, _, _) in SKIP_PATHS.items():
        log(f"path {name}: {title}, {PATH_LAYERS[name]} of 32 layers, calibrated "
            f"skip-softmax decode, Decoder ({time.time() - t_start:.0f} s)")
        by_path[name] = skip_path(torch, name)
    log(f"PTQ phase: Llama-3-8B at full width, {PTQ_LAYERS} layers, the AWQ presets "
        f"quantized, compressed and served on the card ({time.time() - t_start:.0f} s)")
    by_path["PTQ"] = ptq_phase(torch)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        shapes = results[name]
        head = next((r for r in shapes if r["shape"] in PRIMARY), shapes[0])
        per_path = {p: c[name] for p, c in by_path.items() if c[name]}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "entries": ENTRIES.get(name, [name]),
                     "launches": sum(per_path.values()),
                     **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms")},
                     "launches_by_path": per_path, "shapes": shapes})
    log(f"total {time.time() - t_start:.0f} s")
    log(json.dumps({"int8_dynamic_gemm": dynamic["int8_dynamic_gemm"],
                    "gemm_kernels": INT_MM_KERNELS, "weight_copy_kernels": WEIGHT_COPY_KERNELS}))
    log(card_line())  # again, beside the numbers at the end of the log
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
