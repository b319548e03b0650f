#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out FILE]

Phases, each printing JSON lines (and failing loudly on any check):

1. ``device``: the card's name, its power limit from nvidia-smi, the
   torch and CUDA versions.
2. ``build``: nvcc builds every CUDA source of the port from this
   checkout (all sources in parallel).
3. ResNet-50 (K10, K11):
   ``conv_kernel``: K10 (``fused_conv_bn_eval``, with and without its
   ReLU) and K11 (``conv_stats``, and ``conv_stats_pre`` with the
   previous BatchNorm's normalize+ReLU as its prologue) at ResNet-50's
   16 distinct batch-256 conv shapes in bf16, each variant the path
   runs there, against their plain versions (outputs atol 2e-2 plus one
   bf16 rounding step of the value, 2^-7 of it; batch statistics 1e-4),
   with the kernel's time, TFLOP/s and share of the bound, the plain
   version's time, cuDNN's conv of the same x and w (the yardstick), the
   bound and the launch plan (body, slab or per-tap mode, tile width);
   then the JAX package's test shapes, odd channel counts, a ragged
   channel step and a 1x1 image under a 3x3 kernel, bf16 and fp32 (atol
   1e-4). ``conv_summary`` (after the train step): K10 summed over a
   forward's 46 units and K11 over a step's 46, beside cuDNN's and the
   bound.
   ``resnet_infer``:
   ``resnet50(num_classes=1000)`` from the port's seeded initializers,
   bf16, channels-last, space-to-depth stem, eval, 10 timed batches of
   256 x 3 x 224 x 224 under no_grad: images/s, peak memory; asserts 46
   K10 launches a forward (29 with the ReLU, 17 without), no fallback,
   and cuDNN for the 7 convs that do not qualify only. ``resnet_train``:
   bench.py's ResNet-50 train step (bf16, batch 256, Momentum(0.1, 0.9,
   weight_decay=1e-4), cross entropy, one repeated seeded batch), 3
   warm-up and 10 timed steps: ms per step, images/s, peak memory, an
   MFU estimate (3 x the forward's conv and fc operations); asserts
   finite losses, a first loss within 0.5 of ln(1000), a falling loss
   and 46 K11 launches a step (20 plain, 26 with the prologue).
   ``profile`` lines of one eval batch and one train step.
   ``resnet_parity``: fp32, 8 x 3 x 128 x 128, the same weights on the
   card and the CPU (plain versions): eval logits within 1e-4 of the
   largest; one forward and backward with losses to rtol 1e-4 and each
   parameter's gradient, against an fp64 CPU run and relative to its
   own norm, no further off than twice the CPU fp32 run's worst (and
   median) leaf; three Momentum steps at lr 1e-6 with every loss to
   rtol 1e-4 and every weight within lr.
4. ``kernel``: every kernel of the serving and training paths against
   its plain PyTorch version on the card, bf16 (atol 2e-2) and fp32
   (atol 1e-4); with the kernel's time (CUDA events over many launches
   after a warm-up), the plain version's time, the time of
   ``F.scaled_dot_product_attention`` on the same inputs (a yardstick
   the port never calls: forward for K1 and the decode kernels, its
   backward for K2 and K3), and the least time the card could take
   (``bound_ms``, by bytes or by operations). The decode kernels run at
   the serving shapes, the paged ones also at q_len 16 / 17 and
   ``MMA_ROWS`` + 1 (the tensor-core body's one-tile and wide-tile
   edges); each decode row names the kernel body it took (``qrows``,
   ``rows``, ``mma``, ``tiled``). The flash-attention kernels K1-K3 (each row
   naming its body, with its TFLOP/s and share of the bound) compare
   out, lse, dq, dk and dv at ``FLASH_SHAPES`` (the training shape in
   bf16 and fp32, Llama-2-7B's heads, non-causal, segment ids, s =
   1000); a bf16 element may also differ from the plain value by one
   rounding step if the exact value (float64, the same bf16 roundings)
   lies between them (``bf16_flips``).
   The quantized kernels: K5 and K7 (flash decode over int8 / fp8 K/V
   with per-token-per-head scales, dequantized in the kernel) at the
   same serving shapes against their plain versions, with SDPA over the
   dequantized cache as the yardstick, each row with its GB/s and share
   of the bound (the bf16 decode step's rows name ``qrows``); K9 (the weight-only quantized
   matmul) at Llama-2-7B's linear shapes for a decode step (M 8), the
   int8 [2, 2] and [4, 2, 2] verify bundles of 8 slots (M 56, 232) and
   prefill chunks of 128 and 256 tokens, each row naming its body
   (``gemv`` with its ``gemv_plan`` in bf16, ``wgmma`` with its
   ``qmm_plan``, ``simt``) and its bound share, with
   ``torch.matmul`` against the weight dequantized beforehand as the
   yardstick; ``host`` lines give the K9 wrapper's host time per call
   (M 8 and 256, the stream held). K8 (the paged kernels under
   a draft tree's ancestor mask) over bf16 and fp32 pools and int8 /
   fp8 pools with bf16 queries, B 8, 32 heads (group 1, and one group-4
   case), max_len 2048, for a causal bundle of 5 (asserted bit-equal to
   the maskless K6 / K7), the [2, 2] tree (7 nodes) and the [4, 2, 2]
   tree (29); SDPA with the boolean mask over the gathered pool is the
   yardstick. ``split_sweep``: the tensor-core body at the 256-token
   chunk (bf16, int8) and the [4, 2, 2] and [2, 2] verify bundles under
   forced split counts 1, 2, 4 and 8, and the int8 and bf16 decode
   steps (``qrows``, groups 1, 2, 4 and 8, rows as the served traffic's
   decode iteration holds them and as the kernel rows draw them) under 1
   to 32 (each output held to the plain version),
   beside the count ``launch_plan`` picks.
   ``sample`` (no model): the threefry key chain and the samplers on
   the card against the same code on the CPU: Random123's three
   threefry2x32_20 known-answer vectors; 64-link ``split`` chains with a
   ``fold_in`` per link from seeds 0, 7 and 2^31 - 1 (bit-equal);
   uniform and Gumbel draws over [8, 32000] in fp32 and bf16 (bits
   equal, Gumbel within 2 ulp of max(|g|, 1)); ``select_tokens`` over
   temperature 0.7 / 1.0 / 1.3 x top_k 0 / 1 / 40 / 256 / 257 / 32000 x
   top_p 1.0 / 0.9 / 0.5 with greedy rows mixed in, on integer logits
   tied across the 256th value, and plain
   ``generate``'s static selector, on fp32 and bf16 logits: every token
   that differs is counted with its cause and must be a near tie.
5. ``serve``: Llama-2-7B at full width and depth, bf16, seeded random
   N(0, 0.02) weights made on the card, served by the paged engine
   (8 slots, max_len 2048, 16-token blocks, 256-token prefill chunks):
   12 greedy requests, prompts of 48 to 1500 tokens, four sharing a
   512-token prefix. Checks: every request completes with its token
   count; the paged kernel launched exactly layers x (decode steps +
   prefill chunks) times with no paged fallback, and split by kernel
   body exactly: every chunk on the tensor-core body (``mma``; in fp32
   the ``tiled`` SIMT body), every decode step on the decode-step body
   (``qrows``; in fp32 ``rows``). A second engine with 60% of the
   worst-case blocks must preempt and still complete every request.
   ``generate`` on two prompts launches the contiguous kernel (``qrows``;
   in fp32 ``rows``) once per layer per decode step.
   Teacher-forced check: every emitted
   token is the argmax of the plain uncached forward over prompt +
   emitted prefix wherever that forward's top-1/top-2 gap exceeds 0.1.
   In bf16 the agreement is reported; the whole phase then runs again
   on the same weights in fp32, where the check is asserted.
   ``profile``: wall and device time of a prefill and a decode
   iteration of the bf16 engine, and the kernels that take the most
   (``flash_decode_qrows`` must be among the decode iteration's).
   ``serve_sample``: the same traffic with sampling parameters by
   request (greedy; temperature 0.8, top_k 40; top_p 0.9; temperature
   1.2, top_k 12, top_p 0.95; seed 100 + index) through the default
   engine and one at 60% of the blocks (must preempt), with the checks
   of ``serve``; tokens/s beside the greedy engine's; the teacher-forced
   check runs the sampler on the plain forward's logits with each
   token's subkey (reported in bf16; on the oversubscribed engine only
   for the requests whose tokens differ from the default's). In fp32 (after the greedy fp32
   runs) it is asserted, and so are the preemption replay (the
   oversubscribed engine's tokens equal the default's) and ``generate``
   at B = 1 equal to the engine on two sampled requests, a divergence
   allowed only at a near tie (gap at most 0.1, counted). A sampled
   ``profile`` line: the same eight prompts again on the profile's
   engine, every slot sampling (top_p 0.9), its decode iteration beside
   the greedy one, and the sampler alone on its [8, 32000] logits.
   ``serve_spec``: the same bf16 target with ``truncated_draft(target,
   2)`` over the same traffic in the chain (spec_k 4), tree [2, 2] and
   tree [4, 2, 2] lanes, and tree [2, 2] at 60% of the worst-case
   blocks (must preempt). Checks: every request completes with its
   token count; exact launch counts: chunks run both models through
   K6, the chain's verify and its k + 1 draft forwards go through K6,
   the tree's verify and depth + 1 draft forwards through K8 and
   nothing else, every bundle of q_len >= 2 on the tensor-core body and
   every q_len 1 draft step on the decode-step body (``qrows``); no
   fallback. Reports
   tokens/s beside the plain
   engine's, rounds, drafted and accepted tokens, the accept histogram,
   tokens equal to the plain engine's and preemptions. Then the tree
   [2, 2] lane over the first eight requests of the sampled traffic,
   with the same checks, its tokens reported against the plain sampled
   engine's. A ``profile`` of
   a [4, 2, 2] round beside the plain decode step.
   ``http_serve``: the host serving stack on the same bf16 model and
   ``serve``'s engine configuration. ``warmup()`` (0 builds; K6 once a
   layer for the chunk on ``mma`` and once for the step on ``qrows``)
   then ``start()`` with the 12 requests queued: every ``result()``
   bit-equal to ``serve``'s default engine, tokens/s beside it. Then a
   fresh warmed engine behind ``ServingHTTPServer`` on 127.0.0.1: 12
   client threads POST the requests at once (every third streamed); all
   200 and completed with their token counts, each stream's tokens equal
   its record's; ``/healthz`` probed every 50 ms never reads
   ``stalled``; ``/metrics`` parses and its completed requests and
   generated tokens rise by the traffic's; ``/stats`` counts 12 more
   TTFTs; ``/debug/requests`` read during the traffic lists running rows
   with their phase and KV blocks; ``/trace?trace=`` holds one request's
   ``request``, ``queued``, ``prefill`` and ``decode`` spans in order;
   K6 exactly layers x (decode steps + prefill chunks), split by body,
   no fallback; the teacher-forced agreement (reported), tokens/s and
   TTFT / TPOT p50 and p95 beside the started engine's. ``POST /drain``
   with four requests in flight: drained, all four complete, then
   ``/healthz`` and ``POST /generate`` answer 503. On a 1-slot engine:
   an injected loop crash fails its request and reads ``crashed``; an
   injected hang reads ``stalled`` (0.5 s) and, released, completes and
   reads ``ok``. Last, the decode iteration's wall ms with tracing on
   and off (alternating windows of ten) beside the ``profile`` line's.
   ``router_serve``: the stack above the engine on the same bf16 model:
   two ``EngineSupervisor`` replicas of ``serve``'s shape over the one
   model. In
   process behind a ``Router`` (auto_warmup: 0 builds): the 12
   requests at once, all completed, each ``stream()`` equal to its
   ``result()``, both replicas serving, K6 exactly layers x (steps +
   chunks of every engine) + 2 x layers a warmup, by body, no fallback;
   tokens/s, TTFT / TPOT p50 and p95 beside ``serve``'s and
   ``http_serve``'s started engine, bit-equality to ``serve`` and the
   teacher-forced agreement reported. The three fault parts run the
   traffic's prompts at ``ROUTER_FAULT_TOKENS`` new tokens at most. A
   warm restart of r0's engine
   after ``ROUTER_RESTART_STEP`` decode steps: one restart, 0 builds, no
   router retry, r1 never ``stalled``, memory back within 1 GB; its
   wall. A crash storm on r0 (``max_restarts=1``): breaker open, r0
   ejected by the prober, its requests retried on r1 within the
   amplification cap, the router's ``/healthz`` 200 throughout. A poison
   request armed on both replicas: failed with the marker after two
   crashes on one replica (implicated alone both times), refused on
   resubmit, the other 11 complete. Over HTTP (two
   ``ServingHTTPServer``s, two ``HTTPReplica``s, ``RouterHTTPServer``):
   12 clients (every second streamed) all 200, streams equal to records,
   ``/healthz`` never ``stalled``, ``/replicas``, federated ``/metrics``
   (each replica series and the ``fleet`` roll-up rise by the traffic:
   the two replicas share this process's registry), ``/slo``, a merged
   ``/trace``, a poisoned request answered 400 ``quarantined`` twice,
   then ``request_preemption()`` drains the fleet with four requests in
   flight. Last, fp32 at full width and depth 2 through a warm restart
   of r0 and r1's breaker: every request bit-equal to one engine.
6. ``serve_quant``: the same seeded Llama-2-7B converted by
   ``convert_for_serving`` to int8 weight-only linears and served with
   int8 KV blocks over the same 12 requests. Checks: every request
   completes; K7 launches exactly layers x (decode steps + prefill
   chunks), by body exactly: layers x chunks on ``mma``, layers x
   decode steps on ``qrows``; K9 exactly 225 x forwards (7 linears x 32
   layers + lm_head), by body exactly: 225 x prefill chunks on
   ``wgmma``, 225 x decode steps on ``gemv``, with no fallback;
   ``generate(kv_format="int8")`` on two prompts launches K5 (``qrows``)
   once per layer per decode step. Reports tokens/s, KV bytes per token and the
   capacity against bf16, the model's bytes, peak memory, token
   agreement with the bf16 engine and the teacher-forced agreement
   (bf16 activations, reported), and a ``profile`` of its iterations
   (int8 and fp8; ``flash_decode_qrows`` must be among the decode
   iteration's top kernels); then the int8 speculative lane (tree [2, 2], the
   draft converted alike: K7, K8's quantized variant and K9, launch
   counts exact). Then fp8 weights and fp8 KV on four requests,
   with the same checks. ``quant_parity``: Llama-2-7B's width
   at depth 2 in fp32, int8 weights and KV, served on the card and on
   the CPU (plain versions) from the same converted weights: greedy
   tokens equal, the card's ``generate(kv_format="int8")`` equal to the
   card's engine, first-forward logits within 1e-3. ``spec_parity``:
   the same width at depth 2 in fp32 with a 1-layer truncated draft,
   three requests through the chain k4, tree [2, 2] and tree [4, 2, 2]
   lanes on the card and on the CPU, an int8 tree [2, 2] lane and
   offline ``generate`` chain and tree: the card's speculative tokens
   equal its plain tokens and the CPU's, drafted/accepted counts equal
   on both; sampled chain k4 and [2, 2] lanes on the card (three
   samplers) whose tokens equal the card's plain sampled engine; a
   coupled pair (layer 1 zeroed to an identity, the draft its first
   layer) accepts every draft. ``edge``: the engine's last
   prefill chunk past max_len (a 56-token prompt, chunks of 48,
   max_len 64) at the same width and depth in fp32: the card's engine
   tokens equal its ``generate`` and the CPU engine's; the paged kernel
   at that chunk's shape (its table widened by dump-block columns)
   against its plain version in fp32 and bf16.
7. ``train``: the JAX package's bench.py primary point (134M Llama,
   hidden 768, 12 layers of 12 heads, vocab 32000, flash attention) at
   full width and depth in bf16 with fp32 rope tables, seeded N(0, 0.02)
   weights, trained by ``ShardedTrainStep`` with AdamW(1e-4) on one
   repeated 16 x 1024 batch: 3 warm-up and 20 timed steps. Prints the
   losses, ms per step, tokens/s, peak memory and an MFU estimate;
   asserts finite losses, a first loss within 0.5 of ln(32000), a last
   loss below the first, and exactly 12 launches per step of each of
   K1, K2 and K3, every launch on its ``wgmma`` body. ``profile``:
   one train step's wall and device time and top kernels. ``train_parity``: the same width at depth 2, batch 2,
   seq 256 in fp32, three steps on the card and three on the CPU (plain
   versions) from the same weights: losses agree to rtol 1e-4, every
   weight within lr and their mean difference within 1e-3 * lr.
8. GPT-3 1.3B (``GPTConfig.gpt3_1p3b``: 24 layers of 16 heads of 128,
   hidden 2048, vocab 50304; biased linears, learned positions, pre-LN,
   tanh GELU), after the training phases; each phase prints its
   seconds. ``gpt_kernel``: K4-K8 at its shapes (B 8 at the traffic's
   first eight row lengths, max_len 2048, group 1): the decode step
   over bf16 and int8 storage (K4, K5 contiguous; K6, K7 paged), the
   256-token chunk (K6, K7) and the [2, 2] verify bundle (K8 over bf16
   and int8 pools); K9 at its four linear shapes (2048 x 2048, 8192 x
   2048, 2048 x 8192, 50304 x 2048) at M 8 and 256, int8 and fp8; each
   row against its plain version with the ``kernel`` rows' tolerances,
   with the kernel's, the plain version's and the library call's times
   and the bound. ``gpt_serve``: the model in bf16 from seeded weights
   (linear and embedding N(0, 0.02), LayerNorm weights one, biases
   zero; 1,418,842,112 parameters, 196,608 KV bytes a token) through
   the ``serve`` engine over ``TRAFFIC`` (K6 exactly 24 a decode step
   and 24 a chunk, by body, no paged fallback; tokens/s), ``generate``
   on two prompts (K4), a ``profile`` line of its decode iteration, the
   first eight requests (32 new tokens each) sampled (``sample_params``)
   and through the chain (k 4) and tree [2, 2] lanes with
   ``truncated_draft(target, 2)`` (``serve_spec`` lines, launch counts
   exact), then the same weights converted to int8 (biases kept) over
   int8 KV: the traffic (K7 and K9 exactly: 145 products a forward) and
   ``generate(kv_format="int8")`` (K5). ``gpt_parity``: fp32 at full
   width and depth 2, the same weights on the card and the CPU:
   tokens equal for the engine, ``generate``, the chain and tree lanes
   (drafted and accepted counts too), an int8 engine and a sampled
   engine; the C1 edge at ``max_position_embeddings`` 64 = max_len (the
   last chunk's pad tokens past the learned table; card engine = CPU
   engine = card ``generate``, every logit finite); then fp32 at full
   depth on the card: the engine's tokens on four requests pass the
   teacher-forced check against the card's no-cache forward.
9. ``kernels``: one summary object per kernel (K1-K11; K8 and its
   quantized variant, K10 with and without its ReLU, K11 with and
   without its prologue separately); K6 and K7 add their 256-token
   chunk and K8 its [4, 2, 2] verify under ``bundle``; the decode
   kernels and K9 add ``gpt_launches`` (the GPT path's runs) and
   ``gpt`` (the row at GPT-3 1.3B's shape), K6 ``http_launches`` (its
   launches through the HTTP front end) and ``router_launches``
   (through the two replicas' router); then the card's
   nvidia-smi line;
   the last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Exits non-zero, printing no result, without a GPU or outside a checkout
of the repository.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
GAP = 0.1           # teacher-forced check skips near-ties below this gap
DEV = "cuda"

SEED = 0            # weights, prompts and kernel inputs all derive from it
# H100 SXM data-sheet peaks (dense): memory bytes/s and ops/s by input
# dtype (bf16 on the tensor cores, fp32 outside them)
PEAKS = {"bw": 3.35e12, "bfloat16": 989e12, "float32": 67e12}

_out_path = None


def emit(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    if _out_path:
        with open(_out_path, "a") as fh:
            fh.write(line + "\n")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


# card clock cycles (about 0.5 ms) the stream is held per timed call
HOLD_CYCLES = 1_000_000
L2_BYTES = 50 * 2**20   # H100 L2


def cuda_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: a warm-up call, then ``iters`` calls
    enqueued behind a spin kernel that holds the stream, so they run back
    to back and the events time the card rather than the host's launch
    rate (a Python wrapper takes tens of microseconds a call, longer than
    a decode kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bytes(lens, q_len, H, KV, d, itemsize, extra_bytes,
                    kv_itemsize=None, scale_bytes=0):
    """The bytes the attention of these rows must move: each valid K/V
    byte (``kv_itemsize`` each, plus ``scale_bytes`` per token and kv
    head for a quantized cache), q, out and the index inputs once."""
    kv_isz = itemsize if kv_itemsize is None else kv_itemsize
    return sum(lens) * KV * (d * kv_isz + scale_bytes) * 2 \
        + 2 * len(lens) * q_len * H * d * itemsize + extra_bytes


def attention_bound(lens, q_len, H, KV, d, itemsize, extra_bytes,
                    dtype_name, kv_itemsize=None, scale_bytes=0,
                    bundle_pairs=None):
    """Least time for the attention of these rows: its bytes
    (``attention_bytes``) at the memory rate, or 4*d flops per visible
    (query, key) pair at the dtype's peak, whichever is larger.
    ``bundle_pairs``: the visible (query, key) pairs inside the bundle
    of one row and head (a tree's ancestor count; causal by default)."""
    nbytes = attention_bytes(lens, q_len, H, KV, d, itemsize, extra_bytes,
                             kv_itemsize, scale_bytes)
    inner = q_len * (q_len + 1) // 2 if bundle_pairs is None \
        else bundle_pairs
    pairs = sum(H * (q_len * (L - q_len) + inner) for L in lens)
    t_bytes = nbytes / PEAKS["bw"] * 1e3
    t_ops = 4 * d * pairs / PEAKS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(rng):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import decode_attention as da

    dev = torch.device("cuda")
    rows = []
    B, H, d, max_len, bs = 8, 32, 128, 2048, 16
    nb = max_len // bs
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        # paged 16 / 17: the tensor-core body's one-tile edge; MMA_ROWS
        # + 1: its wide row tile's edge
        for kernel, q_lens in (("flash_decode_attention", (1, 8)),
                               ("paged_flash_decode_attention",
                                (1, 16, 17, 32, da.MMA_ROWS + 1, 256))):
            paged = kernel.startswith("paged")
            for q_len in q_lens:
                for group in (1, 4, 8):
                    KV = H // group
                    Bq = 1 if q_len == 256 else B  # one prefill chunk
                    # ragged rows: empty, full, a dead slot, the rest random
                    pos = rng.randint(0, max_len - q_len + 1, Bq)
                    pos[0] = max_len - q_len
                    if Bq > 2:
                        pos[1], pos[2] = 0, 0
                    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
                    q = torch.randn(Bq, q_len, H, d, device=dev).to(dtype)
                    if paged:
                        N = Bq * nb + 1
                        kp = torch.randn(N, bs, KV, d, device=dev).to(dtype)
                        vp = torch.randn(N, bs, KV, d, device=dev).to(dtype)
                        perm = rng.permutation(N - 1)[:Bq * nb] + 1
                        bt_np = perm.reshape(Bq, nb).astype("int32")
                        if Bq > 2:
                            bt_np[2] = 0        # dead slot: zeroed table
                        bt = torch.tensor(bt_np, device=dev)
                        run = lambda: da.paged_flash_decode_attention(  # noqa
                            q, kp, vp, bt, pos_t)
                        plain = lambda: da.paged_flash_decode_attention_ref(  # noqa
                            q, kp, vp, bt, pos_t)
                        kc = kp[bt.long()].reshape(Bq, max_len, KV, d)
                        vc = vp[bt.long()].reshape(Bq, max_len, KV, d)
                        extra = bt.numel() * 4 + Bq * 4
                    else:
                        kc = torch.randn(Bq, max_len, KV, d, device=dev).to(dtype)
                        vc = torch.randn(Bq, max_len, KV, d, device=dev).to(dtype)
                        run = lambda: da.flash_decode_attention(  # noqa
                            q, kc, vc, pos_t)
                        plain = lambda: da.flash_decode_attention_ref(  # noqa
                            q, kc, vc, pos_t)
                        extra = Bq * 4
                    got = run()
                    want = plain()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = err <= ATOL[dname]
                    lens = [min(int(p) + q_len, max_len) for p in pos]
                    # library yardstick: SDPA over the contiguous K/V with
                    # the same ragged causal mask (layout change excluded)
                    qs = q.transpose(1, 2)
                    ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)
                    lens_t = torch.tensor(lens, device=dev)
                    qpos = (lens_t - q_len)[:, None] + torch.arange(
                        q_len, device=dev)[None, :]
                    mask = (torch.arange(max_len, device=dev)[None, None, :]
                            <= qpos[:, :, None])[:, None]
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        qs, ks, vs, attn_mask=mask, enable_gqa=group > 1)
                    bound, bound_by = attention_bound(
                        lens, q_len, H, KV, d, isz, extra, dname)
                    row = {"phase": "kernel", "name": kernel, "dtype": dname,
                           "B": Bq, "q_len": q_len, "heads": H, "kv_heads": KV,
                           "group": group,
                           "body": da.bundle_body(q_len, group, dtype),
                           "head_dim": d, "max_len": max_len,
                           "block_size": bs if paged else None,
                           "pos": [int(p) for p in pos],
                           "max_abs_err": err, "atol": ATOL[dname], "ok": ok,
                           "ms": cuda_ms(run, 50),
                           "plain_ms": cuda_ms(plain, 5),
                           "library_ms": cuda_ms(lib, 20),
                           "bound_ms": bound, "bound_by": bound_by}
                    row["bound_share"] = bound / row["ms"]
                    emit(row)
                    rows.append(row)
                    check(ok, f"{kernel} disagrees with its plain version: "
                              f"{json.dumps(row)}")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# flash attention K1-K3 (the training path)
# ---------------------------------------------------------------------------

FLASH_META = {
    "flash_fwd": ("K1", "paddle_tpu/pallas_kernels/flash_attention.py:211 "
                        "(_flash_fwd, _fwd_kernel :96)"),
    "flash_bwd_dkdv": ("K2", "paddle_tpu/pallas_kernels/flash_attention.py:388 "
                             "(_flash_bwd dK/dV, _bwd_dkdv_kernel :230)"),
    "flash_bwd_dq": ("K3", "paddle_tpu/pallas_kernels/flash_attention.py:426 "
                           "(_flash_bwd dQ, _bwd_dq_kernel :290)"),
}
# (name, [b, s, h, d], dtype, causal, segment ids): the training shape
# first (12 heads of 64, b 16 x s 1024, bf16, causal)
FLASH_SHAPES = [
    ("main", (16, 1024, 12, 64), "bfloat16", True, False),
    ("main_fp32", (16, 1024, 12, 64), "float32", True, False),
    ("llama2_7b_heads", (1, 2048, 32, 128), "bfloat16", True, False),
    ("non_causal", (4, 1024, 12, 64), "bfloat16", False, False),
    ("segments", (4, 1024, 12, 64), "bfloat16", True, True),
    ("s1000", (4, 1000, 12, 64), "bfloat16", True, False),
]


def visible_pairs(b, s, h, causal, seg):
    """(query, key) pairs that attend, summed over batch and heads."""
    import numpy as np

    if seg is None:
        per = s * (s + 1) // 2 if causal else s * s
        return b * h * per
    total = 0
    for row in seg:
        _, counts = np.unique(row, return_counts=True)
        total += sum(int(n) * (int(n) + 1) // 2 if causal else int(n) ** 2
                     for n in counts)
    return h * total


def flash_flops(name, d, pairs):
    """Matrix-product operations of one flash kernel over the visible
    (query, key) pairs: two products in K1, four in K2, three in K3."""
    return {"flash_fwd": 4, "flash_bwd_dkdv": 8, "flash_bwd_dq": 6}[name] \
        * d * pairs


def flash_bound(name, b, s, h, d, isz, pairs, dname):
    """Least time for one flash kernel: inputs read once, outputs written
    once, or its matrix-product operations at the dtype's peak."""
    n = b * s * h * d * isz
    stats = b * h * s * 4
    nbytes = {"flash_fwd": 4 * n + stats,             # q k v -> out, lse
              "flash_bwd_dkdv": 6 * n + 2 * stats,    # q k v do lse delta -> dk dv
              "flash_bwd_dq": 5 * n + 2 * stats}[name]
    flops = flash_flops(name, d, pairs)
    t_bytes = nbytes / PEAKS["bw"] * 1e3
    t_ops = flops / PEAKS[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_exact(q, k, v, do, seg, causal, scale, out_bf16):
    """The plain versions' formulas (``flash_attention_fwd_ref``,
    ``flash_attention_bwd_ref``) in float64 on the same bf16 inputs, with
    their bf16 roundings kept (p before P.V and dV, ds before dK and dQ;
    delta from the bf16 output ``out_bf16``): the exact values that a
    bf16 out, dq, dk and dv round. [b, s, h, d] float64 each."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    bf = torch.bfloat16
    qd, kd, vd, dod = (t.double().transpose(1, 2) for t in (q, k, v, do))
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    mask = fa._visible(q.shape[1], seg, causal, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(bf).double(), vd) / l
    del p
    p = torch.exp(s - (m + torch.log(l)))
    del s
    dv = torch.matmul(p.to(bf).double().transpose(-1, -2), dod)
    delta = (dod * out_bf16.double().transpose(1, 2)).sum(dim=-1)
    ds = (p * (torch.matmul(dod, vd.transpose(-1, -2)) - delta[..., None])
          * scale).to(bf).double()
    del p
    dk = torch.matmul(ds.transpose(-1, -2), qd)
    dq = torch.matmul(ds, kd)
    return tuple(x.transpose(1, 2) for x in (out, dq, dk, dv))


def bf16_flips(got, plain, exact, atol):
    """The bf16 check of a kernel output against its plain version, held
    to the exact value: an element passes within ``atol`` of the plain
    value, or as a one-step rounding flip: the two are neighbouring bf16
    values of one sign and the exact value (``flash_exact``) lies between
    them, so each fp32 sum rounded to its own side of the same edge.
    Returns (every element passes, elements that pass only as flips)."""
    import torch

    x, y = got.double(), plain.double()
    d = (x - y).abs()
    lo, hi = torch.minimum(x, y), torch.maximum(x, y)
    _, e = torch.frexp(torch.minimum(x.abs(), y.abs()))
    step = torch.ldexp(torch.ones_like(d), e - 8)  # bf16 spacing there
    flip = (d == step) & (x * y > 0) & (lo <= exact) & (exact <= hi)
    near = d <= atol
    return bool((near | flip).all()), int((flip & ~near).sum())


def flash_kernel_phase(rng):
    """K1-K3 against their plain versions on the same inputs, with their
    times, the plain versions' and SDPA's (forward for K1, backward for
    K2 and K3), and their bounds. Returns the rows.

    fp32 outputs pass within the fp32 atol of the plain version. A bf16
    out, dq, dk or dv element passes within the bf16 atol of the plain
    version, or as a one-step rounding flip around the exact value
    (``bf16_flips``); the rows give both results' largest distance to
    that value (``exact_err``: kernel, plain)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rows = []
    for label, (b, s, h, d), dname, causal, with_seg in FLASH_SHAPES:
        dtype = getattr(torch, dname)
        isz = torch.empty((), dtype=dtype).element_size()
        q, k, v, do = (torch.randn(b, s, h, d, device=dev).to(dtype)
                       for _ in range(4))
        seg_np = None
        seg = None
        if with_seg:
            # four packed documents per row at seeded cut points
            seg_np = np.stack([np.searchsorted(
                np.sort(rng.choice(np.arange(1, s), 3, replace=False)),
                np.arange(s), "right") for _ in range(b)]).astype(np.int32)
            seg = torch.from_numpy(seg_np).to(dev)
        scale = 1.0 / (d ** 0.5)
        out, lse = fa._launch_fwd(q, k, v, seg, causal, scale)
        delta = fa._delta(out, do, None)
        dk, dv = fa._launch_bwd_kernel("flash_bwd_dkdv", q, k, v, seg, do,
                                       lse, delta, causal, scale)
        dq = fa._launch_bwd_kernel("flash_bwd_dq", q, k, v, seg, do, lse,
                                   delta, causal, scale)
        want_out, want_lse = fa.flash_attention_fwd_ref(q, k, v, seg, causal,
                                                        scale)
        want = fa.flash_attention_bwd_ref(q, k, v, seg, want_out, want_lse,
                                          do, causal, scale)
        torch.cuda.synchronize()

        def err(a, b_):
            return (a.float() - b_.float()).abs().max().item()

        errs = {"out": err(out, want_out), "lse": err(lse, want_lse),
                "dq": err(dq, want[0]), "dk": err(dk, want[1]),
                "dv": err(dv, want[2])}
        passed = {x: e <= ATOL[dname] for x, e in errs.items()}
        flips, exact_err = {}, {}
        if dtype == torch.bfloat16:
            got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
            plain = dict(zip(("out", "dq", "dk", "dv"), (want_out,) + want))
            exact = dict(zip(("out", "dq", "dk", "dv"), flash_exact(
                q, k, v, do, seg, causal, scale, want_out)))
            for x in got:
                passed[x], flips[x] = bf16_flips(got[x], plain[x], exact[x],
                                                 ATOL[dname])
                exact_err[x] = [(got[x].double() - exact[x]).abs().max()
                                .item(), (plain[x].double() - exact[x]).abs()
                                .max().item()]
            del exact, got, plain
        del want
        # yardsticks: SDPA forward, and SDPA's backward from a saved graph
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        mask = None
        if seg is not None:
            mask = seg[:, None, :, None] == seg[:, None, None, :]
            if causal:
                mask = mask & torch.ones(s, s, dtype=torch.bool,
                                         device=dev).tril()
        sdpa_causal = causal and mask is None

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  is_causal=sdpa_causal)

        o_lib = sdpa()
        do_t = do.transpose(1, 2)
        lib_fwd = cuda_ms(lambda: sdpa(), 10)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), do_t, retain_graph=True), 10)
        del o_lib
        plain_fwd = cuda_ms(lambda: fa.flash_attention_fwd_ref(
            q, k, v, seg, causal, scale), 3)
        plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, seg, out, lse, do, causal, scale), 3)
        times = {
            "flash_fwd": (cuda_ms(lambda: fa._launch_fwd(
                q, k, v, seg, causal, scale), 20), plain_fwd, lib_fwd),
            "flash_bwd_dkdv": (cuda_ms(lambda: fa._launch_bwd_kernel(
                "flash_bwd_dkdv", q, k, v, seg, do, lse, delta, causal,
                scale), 20), plain_bwd, lib_bwd),
            "flash_bwd_dq": (cuda_ms(lambda: fa._launch_bwd_kernel(
                "flash_bwd_dq", q, k, v, seg, do, lse, delta, causal, scale),
                20), plain_bwd, lib_bwd),
        }
        pairs = visible_pairs(b, s, h, causal, seg_np)
        checked = {"flash_fwd": ("out", "lse"), "flash_bwd_dkdv": ("dk", "dv"),
                   "flash_bwd_dq": ("dq",)}
        for name, (ms, plain_ms, lib_ms) in times.items():
            bound, bound_by = flash_bound(name, b, s, h, d, isz, pairs, dname)
            e = max(errs[x] for x in checked[name])
            row = {"phase": "kernel", "name": name, "case": label,
                   "dtype": dname, "shape_bshd": [b, s, h, d],
                   "body": fa.fwd_body(dtype) if name == "flash_fwd"
                   else fa.bwd_body(dtype),
                   "causal": causal, "segments": with_seg,
                   "max_abs_err": e,
                   "errs": {x: errs[x] for x in checked[name]},
                   "atol": ATOL[dname],
                   "ok": all(passed[x] for x in checked[name]), "ms": ms,
                   "plain_ms": plain_ms,
                   "plain_covers": "forward" if name == "flash_fwd"
                   else "dq, dk and dv together",
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention "
                              + ("forward" if name == "flash_fwd"
                                 else "backward (dq, dk and dv together)"),
                   "bound_ms": bound, "bound_by": bound_by,
                   "tflops": flash_flops(name, d, pairs) / ms / 1e9,
                   "bound_share": bound / ms}
            if flips:
                row["flips"] = {x: flips[x] for x in checked[name]
                                if x in flips}
                row["exact_err"] = {x: exact_err[x] for x in checked[name]
                                    if x in exact_err}
            emit(row)
            rows.append(row)
            check(row["ok"], f"{name} disagrees with its plain version: "
                             f"{json.dumps(row)}")
        del q, k, v, do, out, lse, delta, dq, dk, dv, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


# the training configuration: the primary point of the JAX package's
# bench.py (bench.py:406-418) at full width and depth
TRAIN_CFG = dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                 num_hidden_layers=12, num_attention_heads=12,
                 num_key_value_heads=12, max_position_embeddings=2048,
                 use_flash_attention=True)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 16, 1024, 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 20


def seeded_llama(cfg, seed, device, dtype):
    """Llama with linear and embedding weights N(0, 0.02) from a seeded
    generator on ``device``, norm weights one; rope tables stay fp32."""
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def device_window(fn, n):
    """Wall ms per call of ``fn`` (host clock, synchronised) and, from a
    torch.profiler trace of ``n`` more calls, the device ms per call (sum
    of kernel times), the idle share and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # kernels only: an operator's own row repeats its kernels' time
    dev = [(e.key, e.self_device_time_total / 1e3 / n)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy = sum(t for _, t in dev)
    top = sorted(dev, key=lambda kv: -kv[1])[:10]
    kinds = {"port_kernels": 0.0, "cublas": 0.0, "cudnn": 0.0, "other": 0.0}
    for k, t in dev:
        kind = "port_kernels" if k.startswith("void flash_") or \
            "flash_decode" in k or "qmm_" in k or any(
                s in k for s in ("conv_tc", "conv_simt", "stats_reduce",
                                 "bn_fold")) else "cudnn" if any(
                s in k.lower() for s in ("cudnn", "xmma", "fprop", "dgrad",
                                         "wgrad", "convolve")) \
            else "cublas" if k.startswith(
                ("nvjet", "sm90_", "cutlass")) or "gemm" in k.lower() \
            else "other"
        kinds[kind] += t
    return {"wall_ms": wall, "device_ms": busy or None,
            "idle_share": (1 - busy / wall) if busy else None,
            "device_ms_by_kind": kinds,
            "top_device_ms": [[k[:80], t] for k, t in top]}


def train_phase(kind):
    """The 134M Llama trained by ``ShardedTrainStep`` with AdamW(1e-4) on
    one repeated numpy-seeded batch (as bench.py does): warm-up and timed
    steps, then a profiled step. Returns the flash launch counts of the
    warm-up and timed steps."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import ShardedTrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, llama_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**TRAIN_CFG)
    L = cfg.num_hidden_layers
    model = seeded_llama(cfg, SEED, DEV, torch.bfloat16)
    check(model.llama.rope_cos.dtype == torch.float32, "rope tables not fp32")
    step = ShardedTrainStep(model, llama_pretrain_loss,
                            AdamW(learning_rate=TRAIN_LR))
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, TRAIN_SEQ))).to(DEV)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (TRAIN_BATCH, TRAIN_SEQ))).to(DEV)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counters()
    losses = [step.step(ids, labels).item()
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step.step(ids, labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    bodies = dict(fa.BODY_LAUNCHES)
    losses += [t.item() for t in timed]
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens * TRAIN_STEPS / secs
    flops_tok = 6 * n_params + 12 * L * TRAIN_SEQ * cfg.hidden_size
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    row = {"phase": "train", "model": "llama_134m (bench.py primary point)",
           "dtype": "bfloat16", "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": TRAIN_LR, "warmup_steps": TRAIN_WARMUP,
           "timed_steps": TRAIN_STEPS, "losses": losses,
           "ms_per_step": secs / TRAIN_STEPS * 1e3, "tokens_per_s": tok_s,
           "peak_memory_gib": peak / 2**30,
           "mfu_estimate": tok_s * flops_tok / PEAKS["bfloat16"],
           "mfu_note": "estimate: bench.py's 6N + 12*L*s*h flops per token "
                       "against the 989 TFLOP/s bf16 data-sheet peak",
           "kernel_launches": launches, "kernel_bodies": bodies,
           "card": kind}
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 0.5,
          f"first loss {losses[0]} not within 0.5 of ln(vocab)")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in fa.LAUNCHES:
        check(launches[name] == L * n_steps,
              f"{name} launched {launches[name]} times, expected "
              f"{L} layers x {n_steps} steps = {L * n_steps}")
    # every forward and backward launch on its wgmma body
    want = {f"{name}/wgmma": L * n_steps for name in fa.LAUNCHES}
    check(bodies == want, f"K1-K3 bodies {bodies}, expected {want}")
    prof = device_window(lambda: step.step(ids, labels), 1)
    emit({"phase": "profile", "model": "llama_134m", "dtype": "bfloat16",
          "what": "one train step (forward, loss, backward, AdamW)",
          "train_step": prof, "card": kind})
    del step, model
    torch.cuda.empty_cache()
    return launches


def train_parity_phase(kind):
    """The training width at depth 2, batch 2, seq 256, in fp32: three
    steps on the card (through the kernels) and three on the CPU (plain
    versions) from the same weights and batch. Losses agree to rtol 1e-4.
    Weights: Adam divides m by sqrt(v), so an element whose gradient sums
    to near zero (|g| ~ eps) can take its step differently on the two
    devices from last-bit differences in g, by up to about one lr; so
    every element is held to atol = lr, and the mean difference to
    1e-3 * lr, which a wrong update rule (off by ~lr on every element)
    cannot meet."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import ShardedTrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_pretrain_loss)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**dict(TRAIN_CFG, num_hidden_layers=2))
    cpu = seeded_llama(cfg, SEED + 1, "cpu", torch.float32)
    gpu = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(SEED + 1)
    ids = rng.randint(0, cfg.vocab_size, (2, 256))
    labels = rng.randint(0, cfg.vocab_size, (2, 256))
    steps = {}
    losses = {}
    fa.reset_counters()
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        steps[name] = ShardedTrainStep(model, llama_pretrain_loss,
                                       AdamW(learning_rate=TRAIN_LR))
        losses[name] = [steps[name].step(ids, labels).item()
                        for _ in range(3)]
    launches = dict(fa.LAUNCHES)
    diffs = {k: (steps["cuda"].params[k].cpu() - steps["cpu"].params[k])
             .abs() for k in steps["cpu"].params}
    w_err, worst = max((d.max().item(), k) for k, d in diffs.items())
    n_elems = sum(d.numel() for d in diffs.values())
    w_mean = sum(d.sum().item() for d in diffs.values()) / n_elems
    n_over = sum(int((d > 0.02 * TRAIN_LR).sum()) for d in diffs.values())
    l_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    row = {"phase": "train_parity", "dtype": "float32", "layers": 2,
           "batch": 2, "seq": 256, "lr": TRAIN_LR, "losses": losses,
           "loss_max_rel_err": l_rel, "loss_rtol": 1e-4,
           "weight_max_abs_err": w_err, "weight_worst": worst,
           "weight_atol": TRAIN_LR, "weight_mean_abs_err": w_mean,
           "weight_mean_atol": 1e-3 * TRAIN_LR,
           "weights_over_0.02_lr": n_over, "weights": n_elems,
           "kernel_launches_cuda": launches, "card": kind}
    emit(row)
    check(l_rel <= 1e-4, f"card and CPU losses differ: {losses}")
    check(w_err <= TRAIN_LR and w_mean <= 1e-3 * TRAIN_LR,
          f"card and CPU weights differ: max {w_err} ({worst}), mean "
          f"{w_mean}")
    check(all(n == 2 * 3 for n in launches.values()),
          f"fp32 card steps did not run the kernels: {launches}")
    del steps, gpu, cpu
    torch.cuda.empty_cache()


def teacher_forced(model, prompt, emitted):
    """Compare each emitted token with the argmax of the plain uncached
    forward over prompt + emitted prefix. Returns (checked, skipped
    near-ties, mismatches as (index, emitted, argmax, gap))."""
    import torch

    seq = list(prompt) + list(emitted)
    P, n = len(prompt), len(emitted)
    ids = torch.tensor([seq[:P + n - 1]], device=DEV)
    with torch.no_grad():
        logits = model(ids)[0, P - 1:].float()
    top2 = logits.topk(2, dim=-1)
    gap = (top2.values[:, 0] - top2.values[:, 1]).tolist()
    arg = top2.indices[:, 0].tolist()
    checked = skipped = 0
    bad = []
    for j in range(n):
        if gap[j] <= GAP:
            skipped += 1
            continue
        checked += 1
        if arg[j] != int(emitted[j]):
            bad.append((j, int(emitted[j]), arg[j], gap[j]))
    return checked, skipped, bad


# the served traffic: (prompt tokens, shares the 512-token prefix, new
# tokens). The first eight prompts take 589 blocks of 16 tokens, and their
# 128 new tokens 64 more: an engine with 60% of the 1025 worst-case blocks
# admits all eight and must preempt while they decode
TRAFFIC = ((1500, False, 128), (530, True, 128), (1480, False, 128),
           (1400, False, 128), (1350, False, 128), (1300, False, 128),
           (1100, False, 128), (700, False, 128), (620, True, 40),
           (800, True, 72), (1024, True, 56), (48, False, 32))


def traffic(rng, vocab):
    """12 greedy requests (``TRAFFIC``): prompts of 48..1500 tokens,
    four sharing a 512-token prefix (one among the first eight admitted,
    three queued behind them so they hit the prefix cache)."""
    shared = rng.randint(1, vocab, 512)

    def prompt(n, share=False):
        tail = rng.randint(1, vocab, n - 512 if share else n)
        return list(shared) + list(tail) if share else list(tail)

    return [(prompt(n, s), m) for n, s, m in TRAFFIC]


def serve_engine(model, requests, draft=None, params=None, **overrides):
    """The traffic through a default-shaped engine; ``params``: one dict
    of sampling parameters per request (None: all greedy)."""
    import torch

    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(max_slots=8, max_len=2048, block_size=16,
                        prefill_chunk=256, **overrides)
    eng = ServingEngine(model, cfg, device=DEV, draft_model=draft)
    params = params or [{}] * len(requests)
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=m, **kw)
            for (p, m), kw in zip(requests, params)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(da.LAUNCHES)
    fallbacks = dict(da.DISPATCH_FALLBACKS)
    return eng, reqs, seconds, launches, fallbacks, dict(da.BODY_LAUNCHES)


def check_bodies(tag, bodies, want):
    """The launches split by kernel body equal ``want`` exactly."""
    got = {k: v for k, v in bodies.items() if v}
    want = {k: v for k, v in want.items() if v}
    check(got == want, f"{tag}: kernel bodies {got}, expected exactly {want}")
    return got


def _teacher_forced_all(model, prompts, outputs, label, strict,
                        params=None):
    """Teacher-forced check over many requests (``params``: their
    sampling parameters, None for greedy); with ``strict`` any confident
    disagreement fails, without it the count is reported."""
    checked = skipped = disagree = 0
    for i, (p, toks) in enumerate(zip(prompts, outputs)):
        c, s, bad = teacher_forced_sampled(model, p, toks, params[i]) \
            if params else teacher_forced(model, p, toks)
        checked, skipped, disagree = checked + c, skipped + s, \
            disagree + len(bad)
        check(not (strict and bad),
              f"{label}: request {i} emitted tokens that are not the plain "
              f"forward's argmax (index, emitted, argmax, gap): {bad[:5]}")
    return {"teacher_forced_checked": checked,
            "teacher_forced_disagree": disagree,
            "near_ties_skipped": skipped, "teacher_forced_asserted": strict}


def check_serve(tag, requests, reqs, st, launches, fallbacks, bodies, L,
                dname, label):
    """A plain engine's run over the traffic: every request completes
    with its token count; the paged kernel launched exactly layers x
    (decode steps + prefill chunks) times, split by body exactly, with
    no paged fallback; an oversubscribed engine preempted. Returns the
    bodies."""
    for r, (p, m) in zip(reqs, requests):
        check(r.status == "completed" and len(r.output_tokens) == m,
              f"{tag}: request {r} did not complete with {m} tokens")
    expect = L * (st["steps"] + st["prefill_chunks"])
    k6 = launches["paged_flash_decode_attention"]
    check(k6 == expect, f"{tag}: paged kernel launched {k6} times, "
                        f"expected {L} x ({st['steps']} steps + "
                        f"{st['prefill_chunks']} chunks) = {expect}")
    # every chunk on the tensor cores (fp32: the SIMT tiles), every
    # decode step on the decode-step body (fp32: the rows body)
    name = "paged_flash_decode_attention"
    chunk, step = ("mma", "qrows") if dname == "bfloat16" \
        else ("tiled", "rows")
    bodies = check_bodies(tag, bodies, {
        f"{name}/{chunk}": L * st["prefill_chunks"],
        f"{name}/{step}": L * st["steps"]})
    paged_fb = {k: v for k, v in fallbacks.items()
                if k.startswith("paged_")}
    check(not paged_fb, f"{tag}: paged fallbacks {paged_fb}")
    if label == "oversubscribed":
        check(st["preemptions"] >= 1, f"{tag}: engine never preempted")
    return bodies


def serve_phase(model, cfg, requests, kind, strict):
    """Both engines (default pool, then 60% of it) over the traffic.
    Returns the default engine's launch counts, outputs, tokens/s and
    tokens/s with TTFT / TPOT p50 and p95."""
    import torch

    L = cfg.num_hidden_layers
    dname = str(next(model.parameters()).dtype).split(".")[-1]
    full = 8 * (2048 // 16) + 1
    out = {}
    for label, overrides in (("default", {}),
                             ("oversubscribed",
                              {"num_blocks": int(0.6 * full)})):
        eng, reqs, secs, launches, fallbacks, bodies = serve_engine(
            model, requests, **overrides)
        st = eng.stats()
        tag = f"{dname} {label}"
        bodies = check_serve(tag, requests, reqs, st, launches, fallbacks,
                             bodies, L, dname, label)
        outputs = [list(r.output_tokens) for r in reqs]
        gen = sum(len(t) for t in outputs)
        row = {"phase": "serve", "engine": label, "model": "llama2_7b",
               "dtype": dname, "requests": len(reqs),
               "num_blocks": eng._nblocks, "decode_steps": st["steps"],
               "prefill_chunks": st["prefill_chunks"],
               "preemptions": st["preemptions"],
               "cow_forks": st["kv_blocks"]["cow_forks"],
               "prefix_cache": st["prefix_cache"],
               "prompt_tokens": sum(len(p) for p, _ in requests),
               "generated_tokens": gen, "seconds": secs,
               "tokens_per_s": gen / secs,
               "ttft_s": _p50_p95([r.ttft_s for r in reqs]),
               "tpot_s": _p50_p95([r.tpot_s for r in reqs]),
               "kernel_launches": launches,
               "kernel_bodies": bodies, "fallbacks": fallbacks, "card": kind}
        del eng
        torch.cuda.empty_cache()
        row.update(_teacher_forced_all(model, [p for p, _ in requests],
                                       outputs, tag, strict))
        if "default" in out:
            row["requests_equal_to_default_engine"] = sum(
                a == b for a, b in zip(out["default"], outputs))
        out[label] = outputs
        emit(row)
        if label == "default":
            main_launches, tps = launches, row["tokens_per_s"]
            perf = {k: row[k] for k in ("tokens_per_s", "ttft_s", "tpot_s")}
    return main_launches, out["default"], tps, perf


# the sampled profile's requests: every slot samples with nucleus 0.9
PROFILE_SAMPLING = dict(do_sample=True, top_p=0.9)


def profile_phase(model, requests, kind, kv_format="bf16", sampled=False,
                  model_name="llama2_7b", windows=(2, 10)):
    """Where a serving iteration's time goes: the first eight requests on
    a default engine, one window of ``windows[0]`` prefill iterations
    (every slot runs a 256-token chunk; none for 0) and one of
    ``windows[1]`` pure decode steps. Wall time per
    iteration is taken without the profiler; device time per iteration
    (the sum of kernel times on the card) from a torch.profiler trace of
    the same number of iterations. ``sampled``: then the same eight
    prompts again on the same engine, every one sampling
    (``PROFILE_SAMPLING``, seeds 100 + index; their prompts' blocks are
    in the prefix cache, so little is prefilled again), a second decode
    window, and the sampler alone (``split_keys`` and ``select_tokens``
    on the step's [8, V] logits and parameters)."""
    import torch

    from paddle_tpu_torch.generation import select_tokens, split_keys
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(max_slots=8, max_len=2048, block_size=16,
                        prefill_chunk=256, kv_format=kv_format)
    eng = ServingEngine(model, cfg, device=DEV)
    for p, m in requests[:8]:
        eng.submit(p, max_new_tokens=m)

    def window(n):
        return device_window(eng.step, n)

    prefill = window(windows[0]) if windows[0] else None
    # through the prompts' prefill (their admission too, when no prefill
    # window ran)
    while eng.scheduler.depth or any(j is not None for j in eng._jobs):
        eng.step()
    decode = window(windows[1])
    weights = next((m.fmt for m in model.modules() if hasattr(m, "fmt")),
                   "bfloat16")
    top = [k for k, _ in decode["top_device_ms"]]
    check(any("flash_decode_qrows" in k for k in top),
          f"{kv_format} decode iteration: flash_decode_qrows is not "
          f"among its top kernels {top}")
    emit({"phase": "profile", "model": model_name, "dtype": "bfloat16",
          "weights": weights, "kv_format": kv_format,
          "slots": 8, "prefill_iteration": prefill,
          "decode_iteration": decode, "card": kind})
    if sampled:
        for i, (p, m) in enumerate(requests[:8]):
            eng.submit(p, max_new_tokens=m,
                       **dict(PROFILE_SAMPLING, seed=100 + i))
        while eng.scheduler.depth or any(j is not None for j in eng._jobs):
            eng.step()
        params = eng._sampler(list(range(8)))
        check(params is not None and eng._slot_sampling.all(),
              "sampled profile: not every slot samples")
        sdecode = window(10)
        logits = torch.randn(8, model.config.vocab_size, device=DEV,
                             dtype=torch.bfloat16)
        keys = eng._keys.clone()

        def sampler():
            _, subs = split_keys(keys)
            select_tokens(logits, subs, *params)

        smp = device_window(sampler, 10)
        emit({"phase": "profile", "model": model_name, "dtype": "bfloat16",
              "weights": weights, "kv_format": kv_format, "slots": 8,
              "sampling": PROFILE_SAMPLING, "decode_iteration": sdecode,
              "greedy_decode_iteration": decode, "sampler": smp,
              "sampler_share_of_decode_device_ms":
                  smp["device_ms"] / sdecode["device_ms"]
                  if smp["device_ms"] and sdecode["device_ms"] else None,
              "card": kind})
    del eng
    torch.cuda.empty_cache()
    return decode


def generate_phase(model, cfg, requests, kind, strict, tags=None):
    """``generate`` on two equal-length prompts: the contiguous kernel
    serves every decode step (the 200-token prefill is declined for
    q_len and runs the plain attention). ``tags`` are added to the
    row."""
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.kernels import decode_attention as da

    S, N = 200, 32
    dname = str(next(model.parameters()).dtype).split(".")[-1]
    prompts = [p[:S] for p, _ in requests[:2]]
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    out = generate(model, prompts, max_new_tokens=N)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(da.LAUNCHES)
    fallbacks = dict(da.DISPATCH_FALLBACKS)
    expect = cfg.num_hidden_layers * (N - 1)
    k4 = launches["flash_decode_attention"]
    check(k4 == expect, f"{dname} generate: contiguous kernel launched {k4} "
                        f"times, expected {cfg.num_hidden_layers} x {N - 1} "
                        f"= {expect}")
    step = "qrows" if dname == "bfloat16" else "rows"
    check_bodies(f"{dname} generate", da.BODY_LAUNCHES,
                 {f"flash_decode_attention/{step}": expect})
    row = {"phase": "generate", "dtype": dname, "B": 2, "prompt_len": S,
           "new_tokens": N, "seconds": secs, "tokens_per_s": 2 * N / secs,
           "kernel_launches": launches, "fallbacks": fallbacks, "card": kind,
           **(tags or {})}
    row.update(_teacher_forced_all(model, prompts,
                                   [out[b, S:].tolist() for b in range(2)],
                                   f"{dname} generate", strict))
    emit(row)
    return launches


# ---------------------------------------------------------------------------
# sampled decode: the threefry key chain, the samplers, the sampled engine
# ---------------------------------------------------------------------------

# the served traffic's sampling parameters by request index (greedy, then
# three samplers), each request seeded 100 + its index
SAMPLE_CYCLE = ({}, dict(do_sample=True, temperature=0.8, top_k=40),
                dict(do_sample=True, top_p=0.9),
                dict(do_sample=True, temperature=1.2, top_k=12, top_p=0.95))
# Random123's threefry2x32_20 known-answer vectors: key, counter, output
THREEFRY_KAT = (((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
                ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
                 (0x1cb996fc, 0xbb002be7)),
                ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0)))
# a sampled token may differ between the card and the CPU only at a near
# tie: the perturbed top two, or the cumulative probability and top_p,
# within this much (float32 math; the last bits of exp and log differ)
NEAR_TIE = 1e-5
# ... and in bfloat16 math (plain generate on bf16 logits): 2 bf16 steps
NEAR_TIE_BF16 = 2.0 ** -6


def sample_params(n):
    """Sampling parameters of ``n`` requests: ``SAMPLE_CYCLE`` by index,
    seed 100 + index."""
    return [dict(SAMPLE_CYCLE[i % len(SAMPLE_CYCLE)], seed=100 + i)
            for i in range(n)]


def _ulp_error(a, b, dtype):
    """Largest |a - b| in ulps of max(|a|, 1) in ``dtype`` (the scale of
    the logits a Gumbel draw perturbs)."""
    import numpy as np
    import torch

    ulp = torch.from_numpy(np.spacing(np.maximum(
        a.abs().numpy(), 1.0).astype(np.float32)))
    if dtype == torch.bfloat16:
        ulp = ulp * 2.0 ** 16
    return float(((a - b).abs() / ulp).max())


def _mismatch_cause(logits, key, filt, top_p):
    """Why one row's draw can differ between devices (on the CPU's
    values): the perturbed top-two gap (Gumbel plus the filtered logits,
    ``filt(logits, top_p)``) and, with a top_p below 1, how near the
    cumulative probability before a value of the top-k-filtered row
    comes to top_p (the nucleus edge)."""
    import torch

    from paddle_tpu_torch import prng
    from paddle_tpu_torch.generation import _scan_cumsum, _softmax

    out = filt(logits, top_p)
    pert = prng.gumbel(key, (out.shape[-1],), out.dtype) + out[0]
    top2 = pert.float().topk(2).values
    cause = {"perturbed_gap": float(top2[0] - top2[1])}
    if top_p < 1.0:
        sd = torch.sort(filt(logits, 1.0), dim=-1, descending=True).values
        probs = _softmax(sd)
        edge = (_scan_cumsum(probs) - probs).float() - top_p
        cause["nucleus_edge"] = float(edge.abs().min())
    return cause


def sample_phase():
    """The threefry key chain and the samplers on the card against the
    same code on the CPU, no model: Random123's known-answer vectors;
    64-link ``split`` chains with a ``fold_in`` per link from three
    seeds; uniform and Gumbel draws over [8, 32000] in fp32 and bf16
    (bits equal, Gumbel within 2 ulp of max(|g|, 1)); ``select_tokens``
    over temperature x top_k x top_p with greedy rows mixed in (and
    integer logits tied across the 256th value) and the
    static selector of plain ``generate``, on fp32 and bf16 logits. Every
    token differing between the devices is counted with its cause and
    must be a near tie (``NEAR_TIE``)."""
    import itertools

    import numpy as np
    import torch

    from paddle_tpu_torch import prng
    from paddle_tpu_torch.generation import (GenerationConfig,
                                             _select_token, _static_filter,
                                             filter_rows, select_tokens)

    t0 = time.perf_counter()
    for key, ctr, want in THREEFRY_KAT:
        t = [torch.tensor([v], dtype=torch.int64, device=DEV)
             for v in key + ctr]
        got = tuple(int(y) for y in prng.threefry2x32(*t))
        check(got == want, f"sample: threefry{key}{ctr} on the card gave "
                           f"{[hex(v) for v in got]}, expected "
                           f"{[hex(v) for v in want]}")
    for seed in (0, 7, 2 ** 31 - 1):
        chains = {}
        for dev in ("cpu", DEV):
            k, links = prng.PRNGKey(seed, dev), []
            for i in range(64):
                k, sub = prng.split(k).unbind(0)
                links += [k, sub, prng.fold_in(k, i)]
            chains[dev] = torch.stack(links).cpu()
        check(torch.equal(chains["cpu"], chains[DEV]),
              f"sample: the key chain of seed {seed} differs on the card")
    draws = {}
    k = prng.PRNGKey(11)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        idt = torch.int16 if dtype == torch.bfloat16 else torch.int32
        u = prng.uniform(k, (8, 32000), dtype)
        ug = prng.uniform(k.to(DEV), (8, 32000), dtype).cpu()
        check(torch.equal(u.view(idt), ug.view(idt)),
              f"sample: {dname} uniform bits differ on the card")
        g = prng.gumbel(k, (8, 32000), dtype).float()
        gg = prng.gumbel(k.to(DEV), (8, 32000), dtype).cpu().float()
        err = _ulp_error(g, gg, dtype)
        check(err <= 2, f"sample: {dname} Gumbel {err} ulp off the CPU's")
        # the same draw with the logs taken in the draw's own dtype, on
        # each device, against the float64 logs prng.gumbel takes
        f32_logs = {}
        for dev in ("cpu", DEV):
            uu = prng.uniform(k.to(dev), (8, 32000), dtype,
                              minval=torch.finfo(dtype).tiny)
            f32_logs[dev] = _ulp_error(
                g, (-torch.log(-torch.log(uu))).cpu().float(), dtype)
        draws[dname] = {"uniform_bits_equal": True, "gumbel_max_ulp": err,
                        "gumbel_values_differing": int((g != gg).sum()),
                        "dtype_logs_max_ulp": {"cpu": f32_logs["cpu"],
                                               "card": f32_logs[DEV]}}

    V = 32000
    grid = list(itertools.product([0.7, 1.0, 1.3], [0, 1, 40, 256, 257, V],
                                  [1.0, 0.9, 0.5]))
    n_greedy = 6
    ds = torch.tensor([True] * len(grid) + [False] * n_greedy)
    temp = torch.tensor([g[0] for g in grid] + [1.0] * n_greedy)
    tk = torch.tensor([g[1] for g in grid] + [0] * n_greedy)
    tp = torch.tensor([g[2] for g in grid] + [1.0] * n_greedy)
    rng = np.random.RandomState(SEED + 12)
    tie = torch.from_numpy(np.round(rng.randn(6, V) * 2).astype(np.float32))
    tie_rows = (torch.ones(6, dtype=torch.bool), torch.ones(6),
                torch.tensor([256, 256, 250, 256, 200, 256]),
                torch.tensor([0.9, 0.99, 0.5, 1.0, 0.95, 0.999]))
    tokens, mismatches = 0, []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        logits = torch.from_numpy(
            (rng.randn(len(ds), V) * 3).astype(np.float32)).to(dtype)
        keys = prng.fold_in(prng.PRNGKey(3), torch.arange(len(ds)))
        args = (ds, temp, tk, tp)
        cases = [("grid", (logits, keys) + args),
                 ("tie", (tie.to(dtype), keys[:6]) + tie_rows)]
        for case, a in cases:
            want = select_tokens(*a)
            got = select_tokens(*(x.to(DEV) for x in a)).cpu()
            tokens += len(want)
            for i in torch.nonzero(want != got).flatten().tolist():
                r = tuple(x[i:i + 1] for x in a[2:])
                cause = _mismatch_cause(
                    a[0][i:i + 1], a[1][i],
                    lambda lg, top_p, r=r: filter_rows(
                        lg, r[1], r[2], torch.full((1,), top_p), r[0]),
                    float(r[3][0]))
                mismatches.append({"dtype": dname, "case": case, "row": i,
                                   "cpu": int(want[i]), "card": int(got[i]),
                                   **cause})
        for j, (t, kk, pp) in enumerate(((0.8, 40, 0.9), (1.0, 0, 0.5),
                                         (1.3, 257, 1.0), (0.7, 1, 0.95))):
            cfg = GenerationConfig(do_sample=True, temperature=t, top_k=kk,
                                   top_p=pp)
            key = prng.PRNGKey(9 + j)
            want = _select_token(logits[:8], cfg, key)
            got = _select_token(logits[:8].to(DEV), cfg, key.to(DEV)).cpu()
            tokens += len(want)
            for i in torch.nonzero(want != got).flatten().tolist():
                # one key over the whole [8, V]: row i's counters start at
                # i * V, so its draw is the flat draw's row i
                lg = logits[:8]
                pert = prng.gumbel(key, lg.shape, lg.dtype) \
                    + _static_filter(lg, cfg)
                top2 = pert[i].float().topk(2).values
                mismatches.append({"dtype": dname, "case": "static",
                                   "config": j, "row": i,
                                   "cpu": int(want[i]), "card": int(got[i]),
                                   "perturbed_gap":
                                       float(top2[0] - top2[1])})
    for m in mismatches:
        near = NEAR_TIE_BF16 if m["case"] == "static" \
            and m["dtype"] == "bfloat16" else NEAR_TIE
        check(min(m["perturbed_gap"], m.get("nucleus_edge", 1.0)) < near,
              f"sample: a token differs between the card and the CPU away "
              f"from any near tie: {m}")
    emit({"phase": "sample", "known_answers": len(THREEFRY_KAT),
          "chain_links": 3 * 64, "draws": draws, "tokens_compared": tokens,
          "token_mismatches": len(mismatches),
          "mismatch_causes": mismatches[:20],
          "seconds": time.perf_counter() - t0})


def teacher_forced_sampled(model, prompt, emitted, params):
    """``teacher_forced`` for a sampled request: each emitted token
    against the port's sampler run on the plain uncached forward's
    logits with that token's subkey (the request's seed chain, one
    split a token). Returns (checked, skipped near-ties, mismatches as
    (index, emitted, sampled, gap)); the gap is the perturbed top-two
    gap (Gumbel plus the filtered logits)."""
    import torch

    from paddle_tpu_torch import prng
    from paddle_tpu_torch.generation import filter_rows, select_tokens

    if not params.get("do_sample"):
        return teacher_forced(model, prompt, emitted)
    seq = list(prompt) + list(emitted)
    P, n = len(prompt), len(emitted)
    ids = torch.tensor([seq[:P + n - 1]], device=DEV)
    with torch.no_grad():
        logits = model(ids)[0, P - 1:].float()
    key, subs = prng.PRNGKey(params["seed"]), []
    for _ in range(n):
        key, sub = prng.split(key).unbind(0)
        subs.append(sub)
    subs = torch.stack(subs).to(DEV)

    def rows(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=DEV)

    ds = rows(True, torch.bool)
    temp = rows(params.get("temperature", 1.0), torch.float32)
    tk = rows(params.get("top_k", 0), torch.long)
    tp = rows(params.get("top_p", 1.0), torch.float32)
    toks = select_tokens(logits, subs, ds, temp, tk, tp).tolist()
    pert = prng.gumbel(subs, (logits.shape[-1],)) \
        + filter_rows(logits, temp, tk, tp, ds)
    top2 = pert.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    checked = skipped = 0
    bad = []
    for j in range(n):
        if gap[j] <= GAP:
            skipped += 1
            continue
        checked += 1
        if toks[j] != int(emitted[j]):
            bad.append((j, int(emitted[j]), toks[j], gap[j]))
    return checked, skipped, bad


def _first_divergence(model, prompt, ref, other, params):
    """Index of the first token where ``other`` leaves ``ref`` and the
    teacher-forced gap there (perturbed top two for a sampled request),
    or None when they agree."""
    import torch

    from paddle_tpu_torch import prng
    from paddle_tpu_torch.generation import filter_rows

    j = next((i for i, (a, b) in enumerate(zip(ref, other)) if a != b),
             None)
    if j is None:
        return None
    seq = list(prompt) + list(ref[:j])
    with torch.no_grad():
        lg = model(torch.tensor([seq], device=DEV))[0, -1:].float()
    if params.get("do_sample"):
        key = prng.PRNGKey(params["seed"])
        for _ in range(j + 1):
            key, sub = prng.split(key).unbind(0)
        one = torch.ones(1, device=DEV)
        lg = prng.gumbel(sub.to(DEV), lg.shape, torch.float32) + filter_rows(
            lg, one * params.get("temperature", 1.0),
            (one * params.get("top_k", 0)).long(),
            one * params.get("top_p", 1.0), one.bool())
    top2 = lg[0].topk(2).values
    return j, float(top2[0] - top2[1])


def serve_sample_phase(model, cfg, requests, kind, strict, greedy_tps):
    """The traffic with sampling parameters (``sample_params``: greedy
    and three samplers, seeds 100 + index) through the default engine
    and one at 60% of the blocks (which must preempt): every request
    completes with its token count; the paged kernel's launches and
    bodies exactly as in ``serve_phase``, no paged fallback; tokens/s
    beside the greedy engine's. The teacher-forced check runs the
    sampler on the plain forward's logits with each token's subkey. With
    ``strict`` (fp32): the oversubscribed engine's tokens (preemption
    replays the key chain) equal the default engine's, and ``generate``
    at B = 1 equals the engine on two sampled requests, a divergence
    allowed only at a near tie (gap at most ``GAP``, counted). Returns
    the default engine's outputs and tokens/s."""
    import torch

    from paddle_tpu_torch.generation import generate

    t0 = time.perf_counter()
    L = cfg.num_hidden_layers
    dname = str(next(model.parameters()).dtype).split(".")[-1]
    params = sample_params(len(requests))
    prompts = [p for p, _ in requests]
    full = 8 * (2048 // 16) + 1
    out = {}
    for label, overrides in (("default", {}),
                             ("oversubscribed",
                              {"num_blocks": int(0.6 * full)})):
        eng, reqs, secs, launches, fallbacks, bodies = serve_engine(
            model, requests, params=params, **overrides)
        st = eng.stats()
        tag = f"serve_sample {dname} {label}"
        bodies = check_serve(tag, requests, reqs, st, launches, fallbacks,
                             bodies, L, dname, label)
        outputs = [list(r.output_tokens) for r in reqs]
        gen = sum(len(t) for t in outputs)
        row = {"phase": "serve_sample", "engine": label,
               "model": "llama2_7b", "dtype": dname,
               "requests": len(reqs),
               "sampled_requests": sum(bool(p.get("do_sample"))
                                       for p in params),
               "params": [SAMPLE_CYCLE[i % len(SAMPLE_CYCLE)]
                          for i in range(len(SAMPLE_CYCLE))],
               "num_blocks": eng._nblocks, "decode_steps": st["steps"],
               "prefill_chunks": st["prefill_chunks"],
               "preemptions": st["preemptions"],
               "generated_tokens": gen, "seconds": secs,
               "tokens_per_s": gen / secs,
               "greedy_tokens_per_s": greedy_tps,
               "kernel_launches": launches, "kernel_bodies": bodies,
               "fallbacks": fallbacks, "card": kind}
        del eng
        torch.cuda.empty_cache()
        # a request whose tokens equal the default engine's carries that
        # engine's check
        tf_req = [i for i, o in enumerate(outputs)
                  if out.get("default") is None or o != out["default"][i]]
        row.update(_teacher_forced_all(
            model, [prompts[i] for i in tf_req], [outputs[i] for i in tf_req],
            tag, strict, [params[i] for i in tf_req]))
        row["teacher_forced_requests"] = tf_req
        if label == "oversubscribed":
            diverged = []
            for i, (a, b) in enumerate(zip(out["default"], outputs)):
                d = _first_divergence(model, prompts[i], a, b, params[i])
                if d is not None:
                    diverged.append((i,) + d)
                    check(not strict or d[1] <= GAP,
                          f"{tag}: request {i} replayed after preemption "
                          f"diverges at token {d[0]} (gap {d[1]})")
            row["requests_equal_to_default_engine"] = \
                len(requests) - len(diverged)
            row["replay_divergences"] = diverged
            row["replay_asserted"] = strict
        out[label] = outputs
        emit(row)
        if label == "default":
            tps = row["tokens_per_s"]
    done = {"phase": "serve_sample", "dtype": dname, "card": kind}
    if strict:
        rows = {}
        for i in (9, 11):
            p, m = requests[i]
            toks = generate(model, [p], max_new_tokens=m,
                            **params[i])[0, len(p):].tolist()
            d = _first_divergence(model, p, out["default"][i], toks,
                                  params[i])
            check(d is None or d[1] <= GAP,
                  f"serve_sample {dname}: generate on request {i} "
                  f"{params[i]} diverges from the engine at token {d}")
            rows[i] = {"params": params[i], "equal": d is None,
                       "divergence": d}
        done.update({"check": "generate B=1", "requests": rows})
    done["phase_seconds"] = time.perf_counter() - t0
    emit(done)
    return out["default"], tps


# ---------------------------------------------------------------------------
# speculative serving: chain and tree lanes, K8 (ancestor-masked paged decode)
# ---------------------------------------------------------------------------

DRAFT_LAYERS = 2    # truncated_draft(target, 2): the serve_spec draft
SPEC_LANES = (("chain k4", dict(spec_k=4)),
              ("tree [2,2]", dict(spec_tree=(2, 2))),
              ("tree [4,2,2]", dict(spec_tree=(4, 2, 2))),
              ("tree [2,2] oversubscribed", dict(spec_tree=(2, 2),
                                                 num_blocks=int(0.6 * 1025))))
# the same lanes over the first requests of the sampled traffic
# (``sample_params``): the tree lane, whose drafts fold the chain subkey
# (the chain lane's sampled tokens are asserted in ``spec_parity``)
SAMPLED_SPEC_LANES = (("tree [2,2] sampled", dict(spec_tree=(2, 2))),)
SAMPLED_SPEC_REQUESTS = 8


def expected_spec_launches(L, Ld, overrides, st, quant):
    """The exact launch counts of a speculative serve: every prefill
    chunk runs both models through the paged kernel; the chain lane's
    verify (q_len k + 1) and its k + 1 draft forwards go through K6 (K7);
    the tree lane's verify and its depth + 1 draft forwards through K8
    and nothing else. K9 (quantized weights): 7 linears a layer and the
    lm_head, per forward of each model."""
    sp = st["spec"]
    chunks, rounds, drafts = st["prefill_chunks"], sp["rounds"], \
        sp["draft_rounds"]
    sfx = "_quant" if quant else ""
    if "spec_tree" in overrides:
        per_draft = len(overrides["spec_tree"]) + 1
        out = {"paged_flash_decode_attention" + sfx: (L + Ld) * chunks,
               "paged_flash_decode_attention_tree" + sfx:
                   L * rounds + Ld * per_draft * drafts}
    else:
        per_draft = overrides["spec_k"] + 1
        out = {"paged_flash_decode_attention" + sfx:
                   L * (rounds + chunks) + Ld * (chunks + per_draft * drafts)}
    if quant:
        out["quant_matmul"] = (7 * L + 1) * (chunks + rounds) \
            + (7 * Ld + 1) * (chunks + per_draft * drafts)
    return out


def expected_spec_bodies(L, Ld, overrides, st, quant):
    """The same launches split by kernel body (bf16): chunks, verify
    bundles and every draft-tree level wider than one node on the
    tensor cores; the chain's draft steps and the tree's root level
    (q_len 1) on the decode-step body ``qrows``, over every pool."""
    sp = st["spec"]
    chunks, rounds, drafts = st["prefill_chunks"], sp["rounds"], \
        sp["draft_rounds"]
    sfx = "_quant" if quant else ""
    paged, tree = "paged_flash_decode_attention" + sfx, \
        "paged_flash_decode_attention_tree" + sfx
    rows = "qrows"
    if "spec_tree" in overrides:
        depth = len(overrides["spec_tree"])
        return {f"{paged}/mma": (L + Ld) * chunks,
                f"{tree}/mma": L * rounds + Ld * depth * drafts,
                f"{tree}/{rows}": Ld * drafts}
    return {f"{paged}/mma": (L + Ld) * chunks + L * rounds,
            f"{paged}/{rows}": Ld * (overrides["spec_k"] + 1) * drafts}


def spec_lane(model, draft, requests, label, overrides, plain, kind,
              quant=False, params=None, model_name="llama2_7b"):
    """One speculative lane over the traffic: every request completes with
    its token count, the launch counts are exact (``expected_spec_launches``)
    with no fallback; reports tokens/s beside the plain engine's of the
    same run, the spec accounting and the tokens equal to the plain
    engine's (with sampling ``params``, the plain sampled engine's).
    Returns the launch counts."""
    import torch

    from paddle_tpu_torch.kernels import quant_matmul as qm

    qm.reset_counters()
    eng, reqs, secs, launches, fallbacks, bodies = serve_engine(
        model, requests, draft=draft, params=params, **overrides)
    qmm = dict(qm.LAUNCHES)
    st = eng.stats()
    sp = st["spec"]
    tag = f"serve_spec {label}"
    for r, (p, m) in zip(reqs, requests):
        check(r.status == "completed" and len(r.output_tokens) == m,
              f"{tag}: request {r} did not complete with {m} tokens")
    L = model.config.num_hidden_layers
    want = {k: v for k, v in expected_spec_launches(
        L, draft.config.num_hidden_layers, overrides, st, quant).items()
        if v}
    got = {k: v for k, v in dict(launches, **qmm).items() if v}
    check(got == want, f"{tag}: launches {got}, expected exactly {want}")
    bodies = check_bodies(tag, bodies, expected_spec_bodies(
        L, draft.config.num_hidden_layers, overrides, st, quant))
    check(not fallbacks and not qm.DISPATCH_FALLBACKS,
          f"{tag}: fallbacks {fallbacks} {dict(qm.DISPATCH_FALLBACKS)}")
    check(sp["verify_kernel"], f"{tag}: verify declined the kernel")
    if "num_blocks" in overrides:
        check(st["preemptions"] >= 1, f"{tag}: engine never preempted")
    outputs = [list(r.output_tokens) for r in reqs]
    gen = sum(len(t) for t in outputs)
    row = {"phase": "serve_spec", "lane": label, "model": model_name,
           "draft": f"truncated_draft(target, {draft.config.num_hidden_layers})",
           "dtype": "bfloat16", "weights": "int8" if quant else "bfloat16",
           "kv_format": "int8" if quant else "bf16",
           "spec": {k: v for k, v in overrides.items() if k != "num_blocks"},
           "requests": len(reqs), "num_blocks": eng._nblocks,
           "rounds": sp["rounds"], "draft_rounds": sp["draft_rounds"],
           "prefill_chunks": st["prefill_chunks"],
           "drafted_tokens": sp["drafted_tokens"],
           "accepted_tokens": sp["accepted_tokens"],
           "accept_rate": sp["accept_rate"],
           "accept_hist": sp["accept_len"]["hist"],
           "mean_accepted": sp["accept_len"]["mean"],
           "preemptions": st["preemptions"],
           "cow_forks": st["kv_blocks"]["cow_forks"],
           "generated_tokens": gen, "seconds": secs,
           "tokens_per_s": gen / secs,
           "plain_bf16_tokens_per_s": plain["bf16_tokens_per_s"],
           "kernel_launches": got, "kernel_launches_expected": want,
           "kernel_bodies": bodies, "card": kind}
    if params:
        row["sampled_requests"] = sum(bool(p.get("do_sample"))
                                      for p in params)
    for name, ref in plain["sampled_outputs" if params
                           else "outputs"].items():
        row[f"tokens_equal_to_plain_{name}_engine"] = sum(
            x == y for a, b in zip(outputs, ref) for x, y in zip(a, b))
        row[f"requests_equal_to_plain_{name}_engine"] = sum(
            a == b for a, b in zip(outputs, ref))
    emit(row)
    del eng
    torch.cuda.empty_cache()
    return got


def serve_spec_phase(model, requests, plain, kind):
    """The bf16 target with its 2-layer truncated draft over the traffic
    in every lane of ``SPEC_LANES``, then over the first
    ``SAMPLED_SPEC_REQUESTS`` of the sampled traffic in
    ``SAMPLED_SPEC_LANES`` (tokens reported against the plain sampled
    engine's). Returns the launch counts by lane."""
    from paddle_tpu_torch.generation import truncated_draft

    draft = truncated_draft(model, DRAFT_LAYERS)
    out = {label: spec_lane(model, draft, requests, label, ov, plain, kind)
           for label, ov in SPEC_LANES}
    n = SAMPLED_SPEC_REQUESTS
    for label, ov in SAMPLED_SPEC_LANES:
        t0 = time.perf_counter()
        out[label] = spec_lane(model, draft, requests[:n], label, ov, plain,
                               kind, params=sample_params(n))
        emit({"phase": "serve_spec", "lane": label,
              "phase_seconds": time.perf_counter() - t0})
    del draft
    return out


def spec_profile_phase(model, requests, kind, plain_decode):
    """Where a speculative round's time goes: the [4, 2, 2] lane on the
    first eight requests, past their prefills, ten rounds (wall without
    the profiler, device from a torch.profiler trace), beside the plain
    engine's decode step of the same run."""
    import torch

    from paddle_tpu_torch.generation import truncated_draft
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    draft = truncated_draft(model, DRAFT_LAYERS)
    eng = ServingEngine(model, ServingConfig(
        max_slots=8, max_len=2048, block_size=16, prefill_chunk=256,
        spec_tree=(4, 2, 2)), device=DEV, draft_model=draft)
    for p, m in requests[:8]:
        eng.submit(p, max_new_tokens=m)
    while any(j is not None for j in eng._jobs):
        eng.step()
    each = []
    for _ in range(5):     # warm-up rounds, each timed on its own
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t0) * 1e3)
    rounds = device_window(eng.step, 10)
    emit({"phase": "profile", "model": "llama2_7b", "dtype": "bfloat16",
          "what": "speculative round, tree [4,2,2] (draft: depth + 1 "
                  "forwards of the 2-layer draft; verify: one 29-wide "
                  "target forward through K8; the path move)",
          "slots": 8, "spec_round": rounds, "warmup_round_wall_ms": each,
          "plain_decode_iteration": plain_decode, "card": kind})
    del eng, draft
    torch.cuda.empty_cache()


HTTP_DRAIN_TOKENS = 32    # new tokens of each request in the drain check
HTTP_TIMEOUT = 600        # seconds a client waits for its response


def _p50_p95(xs):
    xs = [x for x in xs if x is not None]
    if not xs:
        return None
    import numpy as np

    return {"p50": float(np.percentile(xs, 50)),
            "p95": float(np.percentile(xs, 95)), "n": len(xs)}


def _http(base, path, obj=None, timeout=60):
    """(status, headers, body bytes) of one GET (``obj`` None) or POST;
    a 4xx / 5xx answer is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    try:
        resp = urllib.request.urlopen(urllib.request.Request(
            base + path, data=data), timeout=timeout)
        return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _http_client(base, prompt, n, stream, out, i):
    """One ``POST /generate``: ``out[i]`` gets the status, the record,
    the streamed tokens, the wall seconds and (streamed) the seconds to
    the first token line."""
    import urllib.request

    body = {"prompt": [int(t) for t in prompt], "max_new_tokens": n,
            "stream": stream}
    t0 = time.perf_counter()
    first = None
    try:
        resp = urllib.request.urlopen(urllib.request.Request(
            f"{base}/generate", data=json.dumps(body).encode()),
            timeout=HTTP_TIMEOUT)
        if stream:
            lines = []
            for raw in resp:
                if raw.strip():
                    lines.append(json.loads(raw))
                    if first is None and "token" in lines[-1]:
                        first = time.perf_counter() - t0
            rec = lines[-1]
            toks = [x["token"] for x in lines if "token" in x]
        else:
            rec, toks = json.loads(resp.read()), None
        out[i] = {"code": resp.status, "record": rec, "streamed": toks,
                  "seconds": time.perf_counter() - t0, "client_ttft_s": first}
    except Exception as e:  # noqa: BLE001 — reported and checked below
        out[i] = {"code": getattr(e, "code", None), "error": repr(e)}


def observability_write_us(n=20000):
    """Host µs of one write of each kind a decode iteration of the
    engine makes (per step: a counter, a histogram, an engine-lane trace
    event; per token: a labelled counter, a histogram and a summary),
    on instruments of their own (the serving ones stay untouched)."""
    from paddle_tpu_torch.observability import metrics, tracing

    reg = metrics.MetricsRegistry()
    ops = {"counter_inc": reg.counter("c_total", "").inc,
           "labelled_counter_inc":
               lambda: reg.counter("l_total", "", ("k",)).labels(
                   "generated").inc(),
           "histogram_observe": lambda: reg.histogram("h", "").observe(0.04),
           "summary_observe": lambda: reg.summary("s", "").observe(0.04),
           "trace_complete": lambda: tracing.complete(
               "serving.step", "engine", "probe", 0, 1, {"active": 8})}
    out = {}
    for name, fn in ops.items():
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    tracing.clear()
    return out


def http_serve_phase(model, cfg, requests, kind, bf16_outputs, bf16_tps,
                     plain_decode):
    """The host serving stack on the card (the engine lifecycle, the
    metrics registry, request tracing and the HTTP front end) at
    Llama-2-7B's full width, bf16, ``serve``'s engine configuration and
    traffic. Returns the HTTP run's K6 launches and the started engine's
    and the HTTP run's tokens/s, TTFT and TPOT."""
    import gc
    import threading

    import torch

    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.observability import exporters, tracing
    from paddle_tpu_torch.serving import (ChaosEngine, ServingConfig,
                                          ServingEngine, ServingHTTPServer)

    t_phase = time.perf_counter()
    L = cfg.num_hidden_layers
    name = "paged_flash_decode_attention"
    shape = dict(max_slots=8, max_len=2048, block_size=16, prefill_chunk=256)

    def fresh(**overrides):
        return ServingEngine(model, ServingConfig(**dict(shape, **overrides)),
                             device=DEV)

    def free():
        """Give back the device memory of the engines the caller let go
        (each holds a pool of about 8.7 GB at this shape)."""
        gc.collect()
        torch.cuda.empty_cache()

    def latencies(ttft, tpot):
        return {"ttft_s": _p50_p95(ttft), "tpot_s": _p50_p95(tpot)}

    def paged_fallbacks():
        return {k: v for k, v in da.DISPATCH_FALLBACKS.items()
                if k.startswith("paged_")}

    # 1. warmup, then the background loop over the queued traffic
    eng = fresh()
    da.reset_counters()
    warm = eng.warmup()
    check(warm["compiles"] == 0,
          f"http_serve: warmup built {warm['compiles']} libraries after "
          f"build_all")
    check(da.LAUNCHES[name] == 2 * L,
          f"http_serve: warmup launched K6 {da.LAUNCHES[name]} times, "
          f"expected one chunk and one step a layer = {2 * L}")
    check_bodies("http_serve warmup", da.BODY_LAUNCHES,
                 {f"{name}/mma": L, f"{name}/qrows": L})
    again = eng.warmup()
    check(again["compiles"] == 0, "http_serve: a second warmup built")
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.start()
    outs = [r.result(timeout=HTTP_TIMEOUT) for r in reqs]
    secs = time.perf_counter() - t0
    eng.stop()
    equal = sum(a == b for a, b in zip(outs, bf16_outputs))
    check(all(r.status == "completed" for r in reqs) and
          equal == len(reqs),
          f"http_serve: the started engine gave {equal} of {len(reqs)} "
          f"requests bit-equal to serve's default engine")
    started = {"tokens_per_s": sum(map(len, outs)) / secs, "seconds": secs,
               **latencies([r.ttft_s for r in reqs],
                           [r.tpot_s for r in reqs])}
    emit({"phase": "http_serve", "part": "warmup + start", "model":
          "llama2_7b", "dtype": "bfloat16", "requests": len(reqs),
          "warmup_wall_s": warm["wall_s"], "warmup_compiles":
          warm["compiles"], "warmup_entries": warm["entries"],
          "second_warmup": again, "equal_to_serve": equal,
          "serve_tokens_per_s": bf16_tps, **started,
          "steps": eng.stats()["steps"], "card": kind})
    del eng, reqs
    free()

    # 2. the HTTP front end: twelve clients at once
    eng = fresh()
    eng.warmup()
    srv = ServingHTTPServer(eng, port=0)
    base = f"http://127.0.0.1:{srv.port}"

    def families():
        return exporters.parse_prometheus_text(
            _http(base, "/metrics")[2].decode())

    def sample(fams, fam, **labels):
        return sum(s["value"] for s in fams[fam]["samples"]
                   if all(s["labels"].get(k) == v
                          for k, v in labels.items()))

    fams0 = families()
    ttft0 = json.loads(_http(base, "/stats")[2])[
        "latency_digests"]["ttft_s"]["count"]
    da.reset_counters()
    probes, running_rows = [], []
    done = threading.Event()

    def prober():
        while not done.is_set():
            code, _, body = _http(base, "/healthz")
            probes.append((code, json.loads(body)["status"]))
            if not running_rows:
                dbg = json.loads(_http(base, "/debug/requests")[2])
                running_rows.extend(dbg["running"])
            done.wait(0.05)

    results = [None] * len(requests)
    clients = [threading.Thread(target=_http_client, args=(
        base, p, m, i % 3 == 2, results, i)) for i, (p, m) in
        enumerate(requests)]
    probe = threading.Thread(target=prober)
    probe.start()
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    secs = time.perf_counter() - t0
    done.set()
    probe.join()
    st = eng.stats()
    launches, bodies = dict(da.LAUNCHES), dict(da.BODY_LAUNCHES)
    for i, ((p, m), res) in enumerate(zip(requests, results)):
        rec = res.get("record") or {}
        check(res.get("code") == 200 and rec.get("status") == "completed"
              and len(rec.get("tokens", ())) == m,
              f"http_serve: request {i} answered {res}")
        if res["streamed"] is not None:
            check(res["streamed"] == rec["tokens"],
                  f"http_serve: request {i}'s stream differs from its "
                  f"record")
    https = [r["record"]["tokens"] for r in results]
    gen = sum(map(len, https))
    stalled = [s for s in probes if s[1] == "stalled"]
    check(probes and not stalled and set(probes) <= {(200, "ok"),
                                                     (503, "saturated")},
          f"http_serve: /healthz during the traffic read "
          f"{sorted(set(probes))}")
    fams1 = families()
    done_delta = sample(fams1, "paddle_tpu_serving_requests_total",
                        outcome="completed") - sample(
        fams0, "paddle_tpu_serving_requests_total", outcome="completed")
    gen_delta = sample(fams1, "paddle_tpu_serving_tokens_total",
                       kind="generated") - sample(
        fams0, "paddle_tpu_serving_tokens_total", kind="generated")
    check(done_delta == len(requests) and gen_delta == gen,
          f"http_serve: /metrics rose by {done_delta} completed requests "
          f"and {gen_delta} generated tokens, expected {len(requests)} "
          f"and {gen}")
    stats = json.loads(_http(base, "/stats")[2])
    ttft_delta = stats["latency_digests"]["ttft_s"]["count"] - ttft0
    check(ttft_delta == len(requests),
          f"http_serve: /stats counted {ttft_delta} TTFTs")
    check(running_rows and all("phase" in r and "kv_blocks" in r
                               for r in running_rows),
          f"http_serve: /debug/requests during the traffic: "
          f"{running_rows[:1]}")
    rid = results[0]["record"]["request_id"]
    ct = json.loads(_http(base, f"/trace?trace={rid}")[2])["traceEvents"]
    spans = {}
    for e in ct:
        if e["ph"] == "X":
            spans.setdefault(e["name"], e)
    order = ("request", "queued", "prefill", "decode")
    check(all(n in spans for n in order) and
          [spans[n]["ts"] for n in order] ==
          sorted(spans[n]["ts"] for n in order) and
          all(spans[n]["ts"] + spans[n]["dur"] <=
              spans["request"]["ts"] + spans["request"]["dur"] + 1e-3
              for n in order),
          f"http_serve: request {rid}'s trace spans "
          f"{ {n: spans.get(n) for n in order} }")
    expect = L * (st["steps"] + st["prefill_chunks"])
    check(launches[name] == expect,
          f"http_serve: K6 launched {launches[name]} times, expected {L} "
          f"x ({st['steps']} steps + {st['prefill_chunks']} chunks) = "
          f"{expect}")
    check_bodies("http_serve", bodies, {
        f"{name}/mma": L * st["prefill_chunks"],
        f"{name}/qrows": L * st["steps"]})
    check(not paged_fallbacks(),
          f"http_serve: paged fallbacks {paged_fallbacks()}")
    row = {"phase": "http_serve", "part": "http", "model": "llama2_7b",
           "dtype": "bfloat16", "requests": len(requests),
           "streamed": sum(r["streamed"] is not None for r in results),
           "generated_tokens": gen, "seconds": secs,
           "tokens_per_s": gen / secs,
           **latencies([r["record"]["ttft_s"] for r in results],
                       [r["record"]["tpot_s"] for r in results]),
           "client_ttft_s_streamed": _p50_p95(
               [r["client_ttft_s"] for r in results]),
           "client_seconds": _p50_p95([r["seconds"] for r in results]),
           "started_engine": started, "healthz_probes": len(probes),
           "healthz_states": sorted({s for _, s in probes}),
           "decode_steps": st["steps"], "prefill_chunks":
           st["prefill_chunks"], "kernel_launches": launches,
           "kernel_bodies": bodies,
           "requests_equal_to_serve": sum(
               a == b for a, b in zip(https, bf16_outputs)),
           "card": kind}
    row.update(_teacher_forced_all(model, [p for p, _ in requests], https,
                                   "http_serve", False))
    emit(row)

    # 3. drain with four requests in flight
    drain_out = [None] * 4
    clients = [threading.Thread(target=_http_client, args=(
        base, p, HTTP_DRAIN_TOKENS, False, drain_out, i))
        for i, (p, _) in enumerate(requests[:4])]
    for c in clients:
        c.start()
    t0 = time.perf_counter()
    while len(eng.scheduler) + eng.busy_slots() < 4:
        check(time.perf_counter() - t0 < 60,
              "http_serve: the drain's requests never arrived")
        time.sleep(0.005)
    code, _, body = _http(base, "/drain", {"timeout_s": 300}, timeout=400)
    drained = json.loads(body)
    for c in clients:
        c.join()
    hcode, _, hbody = _http(base, "/healthz")
    gcode, _, _ = _http(base, "/generate",
                        {"prompt": [1, 2, 3], "max_new_tokens": 2})
    check(code == 200 and drained["drained"] is True,
          f"http_serve: POST /drain answered {code} {drained}")
    check(all(r["code"] == 200 and r["record"]["status"] == "completed"
              and len(r["record"]["tokens"]) == HTTP_DRAIN_TOKENS
              for r in drain_out),
          f"http_serve: the drained requests ended {drain_out}")
    hstatus = json.loads(hbody)["status"]
    check(hcode == 503 and hstatus in ("draining", "stopped") and
          gcode == 503, f"http_serve: after the drain /healthz "
                        f"{hcode} {hstatus}, POST /generate {gcode}")
    srv.stop()
    eng.stop()
    emit({"phase": "http_serve", "part": "drain", "in_flight": 4,
          "drained": drained, "healthz_after": [hcode, hstatus],
          "generate_after": gcode, "card": kind})
    del eng, srv
    free()

    # 4. a crash and a stall on a 1-slot engine (the crash's flight dump
    # goes to the temp dir, or $PADDLE_TPU_SINK_DIR)
    small = dict(max_slots=1, max_len=64, block_size=16, prefill_chunk=64)
    prompt = requests[-1][0][:24]
    eng = ServingEngine(model, ServingConfig(**small), device=DEV)
    eng.warmup()
    monkey = ChaosEngine(eng).crash_after_steps(0)
    req = eng.submit(prompt, max_new_tokens=8)
    eng.start()
    req.result(timeout=60)
    ccode, cpay = eng.health()
    check(req.status == "failed" and "chaos" in req.error and
          (ccode, cpay["status"]) == (503, "crashed") and
          monkey.injected["crash"] == 1,
          f"http_serve: crash: request {req.status}, health {ccode} "
          f"{cpay['status']}")
    dump = tracing.last_flight_dump()
    eng.stop()
    eng = ServingEngine(model, ServingConfig(stall_timeout_s=0.5,
                                             **small), device=DEV)
    eng.warmup()
    monkey = ChaosEngine(eng).hang_after_steps(1)
    req = eng.submit(prompt, max_new_tokens=16)
    eng.start()
    t0 = time.perf_counter()
    while eng.health()[1]["status"] != "stalled":
        check(time.perf_counter() - t0 < 30,
              f"http_serve: the hung loop never read stalled "
              f"({eng.health()[1]['status']})")
        time.sleep(0.02)
    stalled_after = time.perf_counter() - t0
    spay = eng.health()[1]
    monkey.release()
    req.result(timeout=60)
    t0 = time.perf_counter()
    while eng.health()[0] != 200:
        check(time.perf_counter() - t0 < 10,
              f"http_serve: after the release health reads "
              f"{eng.health()[1]['status']}")
        time.sleep(0.01)
    check(req.status == "completed" and len(req.output_tokens) == 16,
          f"http_serve: the released request ended {req.status}")
    eng.stop()
    emit({"phase": "http_serve", "part": "crash and stall",
          "crashed": cpay["crashed"], "flight_dump": dump,
          "stalled_payload": {k: spay[k] for k in ("status", "stalled_s",
                                                   "slots_busy")},
          "seconds_to_stalled": stalled_after, "card": kind})
    del eng, monkey, req
    free()

    # 5. the host cost of observability: the decode iteration of eight
    # slots in alternating windows of ten steps, tracing on and off; and
    # the host time of one write of each kind the iteration makes
    eng = fresh()
    eng.warmup()
    for p, m in requests[:8]:
        eng.submit(p, max_new_tokens=m)
    while eng.scheduler.depth or any(j is not None for j in eng._jobs):
        eng.step()
    walls = {"on": [], "off": []}
    try:
        for mode in ("on", "off") * 3:
            (tracing.enable_tracing if mode == "on"
             else tracing.disable_tracing)()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                eng.step()
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) / 10 * 1e3)
    finally:
        tracing.enable_tracing()
    on, off = (sum(walls[k]) / len(walls[k]) for k in ("on", "off"))
    emit({"phase": "http_serve", "part": "tracing cost", "slots": 8,
          "decode_iteration_wall_ms": walls, "tracing_on_ms": on,
          "tracing_off_ms": off, "tracing_cost_ms": on - off,
          "profile_decode_wall_ms": plain_decode["wall_ms"],
          "host_us_per_write": observability_write_us(),
          "card": kind})
    eng.stop(abort=True)
    del eng
    free()
    emit({"phase": "http_serve", "part": "done",
          "phase_seconds": time.perf_counter() - t_phase})
    return {name: launches[name]}, {
        "started": {k: started[k] for k in ("tokens_per_s", "ttft_s",
                                            "tpot_s")},
        "http": {k: row[k] for k in ("tokens_per_s", "ttft_s", "tpot_s")}}


ROUTER_CRASH_STEP = 8     # r0 decode steps before the storm is armed
# new tokens a request at most in the restart, failover and poison
# parts: their checks hold at any length, and each suspect of a crash
# replays alone (as a probe) through its prompt and its tokens so far
ROUTER_FAULT_TOKENS = 48
# r0 decode steps before its warm restart: late in those requests, so
# the suspects have few tokens left
ROUTER_RESTART_STEP = 40
# the phase's pollers: /healthz probes every 0.1 s; a wait for an
# engine's state reads a counter every 20 ms (``stats()`` at 200 Hz took
# enough of the GIL from the loop threads to double a part's wall time)
ROUTER_POLL_S = 0.1
ROUTER_POISON = 24        # prompt tokens of the poisoned request
ROUTER_FP32_TOKENS = 32   # new tokens a request in the fp32 check


def _wait(cond, what, timeout=HTTP_TIMEOUT, every=0.02):
    """Poll ``cond`` until it holds; fail the phase after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout,
              f"router_serve: timed out waiting for {what}")
        time.sleep(every)


def _router_fleet(model, shape, sups_kw, engines):
    """Supervisors of ``model`` on the card (``sups_kw``: one dict of
    supervisor options a replica) with every engine they ever build
    appended to ``engines``."""
    from paddle_tpu_torch.serving import EngineSupervisor, ServingConfig

    sups = []
    for kw in sups_kw:
        sup = EngineSupervisor(model, ServingConfig(**shape), device=DEV,
                               **kw)
        engines.append(sup.engine)
        sup.add_rebuild_hook(engines.append)
        sups.append(sup)
    return sups


def _router_launches(tag, engines, L, dname):
    """K6 launched exactly layers x (decode steps + prefill chunks) of
    every engine that lived, plus one chunk and one step a layer for
    each warmup, split by body, with no paged fallback (the counts since
    the caller's ``reset_counters``). Returns the counts."""
    from paddle_tpu_torch.kernels import decode_attention as da

    name = "paged_flash_decode_attention"
    launches, bodies = dict(da.LAUNCHES), dict(da.BODY_LAUNCHES)
    steps = sum(e.stats()["steps"] for e in engines)
    chunks = sum(e.stats()["prefill_chunks"] for e in engines)
    warm = sum(e.warmed_up for e in engines)
    expect = L * (steps + chunks + 2 * warm)
    check(launches[name] == expect,
          f"{tag}: K6 launched {launches[name]} times, expected {L} x "
          f"({steps} steps + {chunks} chunks + 2 x {warm} warmups) = "
          f"{expect}")
    chunk, step = ("mma", "qrows") if dname == "bfloat16" \
        else ("tiled", "rows")
    check_bodies(tag, bodies, {f"{name}/{chunk}": L * (chunks + warm),
                               f"{name}/{step}": L * (steps + warm)})
    paged_fb = {k: v for k, v in da.DISPATCH_FALLBACKS.items()
                if k.startswith("paged_")}
    check(not paged_fb, f"{tag}: paged fallbacks {paged_fb}")
    return {"launches": launches[name], "steps": steps, "chunks": chunks,
            "warmups": warm, "engines": len(engines),
            "bodies": {k: v for k, v in bodies.items() if v}}


def router_serve_phase(model, cfg, requests, kind, bf16_outputs, refs):
    """The serving stack above the engine on the card: two supervised
    replicas of the bf16 Llama-2-7B (``serve``'s engine shape, one
    shared model) behind a ``Router``, in process and over HTTP, with a
    warm restart, a failover, a poison quarantine and the SIGTERM drain;
    then an fp32 depth-2 run through a restart and a failover, asserted
    bit-equal to one engine. ``refs``: ``serve``'s and ``http_serve``'s
    numbers from this call, reported beside the router's. Returns the
    in-process run's K6 launches."""
    import gc
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch.fault_tolerance.preemption import (
        clear_preemption, request_preemption, uninstall_preemption_handler)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.observability import exporters
    from paddle_tpu_torch.serving import (
        HTTPReplica, LocalReplica, PoisonedRequestError, Router, RouterConfig,
        RouterHTTPServer, SamplingParams, ServingConfig, ServingEngine,
        ServingHTTPServer, SupervisedChaos, install_sigterm_drain,
        request_fingerprint, uninstall_sigterm_drain)
    from paddle_tpu_torch.serving.router_http import router_health
    from paddle_tpu_torch.serving.supervisor import POISON_MARKER

    t_phase = time.perf_counter()
    builds0 = _build.total_builds()
    L = cfg.num_hidden_layers
    name = "paged_flash_decode_attention"
    shape = dict(max_slots=8, max_len=2048, block_size=16, prefill_chunk=256)
    prompts = [p for p, _ in requests]
    engines = []

    def free():
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()

    def latencies(rrs):
        return {"ttft_s": _p50_p95([r.ttft_s for r in rrs]),
                "tpot_s": _p50_p95([r.tpot_s for r in rrs])}

    def in_process(sups, **router_kw):
        da.reset_counters()
        router = Router([LocalReplica(s, f"r{i}")
                         for i, s in enumerate(sups)],
                        RouterConfig(seed=0, **router_kw))
        return router.start()

    def run(router, reqs=requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rrs = [router.submit(p, max_new_tokens=m) for p, m in reqs]
        return rrs, t0

    def same(outs, ref):
        """Requests whose tokens equal ``ref``'s (its first as many)."""
        return sum(a == b[:len(a)] for a, b in zip(outs, ref))

    def finish(tag, rrs, t0, reqs=requests):
        outs = [rr.result(timeout=HTTP_TIMEOUT) for rr in rrs]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for i, (rr, (_, m)) in enumerate(zip(rrs, reqs)):
            streamed = list(rr.stream(timeout=5))
            check(rr.status == "completed" and len(outs[i]) == m and
                  streamed == outs[i],
                  f"{tag}: request {i} ended {rr.status} ({rr.error}) with "
                  f"{len(outs[i])} of {m} tokens, stream {len(streamed)}")
        gen = sum(map(len, outs))
        return outs, {"seconds": secs, "generated_tokens": gen,
                      "tokens_per_s": gen / secs, **latencies(rrs)}

    # 1. two supervised replicas in process: auto_warmup builds nothing
    sups = _router_fleet(model, shape, [{}, {}], engines)
    router = in_process(sups)
    check(_build.total_builds() == builds0,
          "router_serve: auto_warmup built a kernel library")
    check(all(s.warmed_up for s in sups), "router_serve: a cold replica")
    rrs, t0 = run(router)
    outs, perf = finish("router_serve in process", rrs, t0)
    served = sorted({rr.replica for rr in rrs})
    check(served == ["r0", "r1"],
          f"router_serve: replicas that served: {served}")
    k6 = _router_launches("router_serve in process", engines, L, "bfloat16")
    router.stop(drain=True, timeout_s=60)
    row = {"phase": "router_serve", "part": "in process", "model":
           "llama2_7b", "dtype": "bfloat16", "replicas": 2,
           "requests": len(rrs), "per_replica": {
               r: sum(rr.replica == r for rr in rrs) for r in served},
           "retries": sum(rr.retries for rr in rrs), **perf,
           "k6": k6,
           "equal_to_serve": sum(a == b for a, b in zip(outs, bf16_outputs)),
           "serve": refs["serve"], "http_serve_started": refs["started"],
           "card": kind}
    row.update(_teacher_forced_all(model, prompts, outs, "router_serve",
                                   False))
    emit(row)
    router_launches = {name: k6["launches"]}
    del router, sups, rrs
    free()

    faulty = [(p, min(m, ROUTER_FAULT_TOKENS)) for p, m in requests]

    # 2. a warm restart of r0's engine mid-decode, absorbed by its
    # supervisor (the survivor r1 is polled for stalls meanwhile)
    sups = _router_fleet(model, shape, [{}, {}], engines)
    chaos = SupervisedChaos(sups[0])
    router = in_process(sups)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    states, done = [], threading.Event()

    def poll_survivor():
        while not done.is_set():
            states.append(sups[1].health()[1]["status"])
            done.wait(ROUTER_POLL_S)

    poller = threading.Thread(target=poll_survivor)
    poller.start()
    rrs, t0 = run(router, faulty)
    _wait(lambda: sups[0].engine._steps >= ROUTER_RESTART_STEP,
          "r0's decode steps")
    decoding = sum(sups[0].engine._decoding)
    chaos.current.crash_after_steps(0)
    _wait(lambda: sups[0].restarts == 1 and not sups[0].restarting,
          "the warm restart")
    mem_restart = torch.cuda.memory_allocated()
    outs, perf = finish("router_serve restart", rrs, t0, faulty)
    done.set()
    poller.join()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    st = router.stats()
    k6 = _router_launches("router_serve restart", engines, L, "bfloat16")
    sup_st = sups[0].supervisor_stats()
    check(chaos.injected["crash"] == 1 and sup_st["restarts"] == 1 and
          not sup_st["broken"] and decoding >= 1,
          f"router_serve: restart: injected {chaos.injected}, "
          f"{decoding} decoding slots at the crash, supervisor {sup_st}")
    check(_build.total_builds() == builds0,
          "router_serve: the restart's warmup built a kernel library")
    check(st["extra_attempts"] == 0 and all(rr.retries == 0 for rr in rrs),
          f"router_serve: the router retried through a supervised restart "
          f"({st['extra_attempts']} extra attempts)")
    check(abs(mem1 - mem0) < 2**30,
          f"router_serve: memory {mem1} bytes after the restart, {mem0} "
          f"before the crash")
    check("stalled" not in states,
          f"router_serve: r1 read {sorted(set(states))} during r0's restart")
    router.stop(drain=True, timeout_s=60)
    emit({"phase": "router_serve", "part": "warm restart",
          "restart_wall_s": sups[0]._last_restart_s,
          "decoding_slots_at_crash": decoding,
          "supervisor": {k: sup_st[k] for k in (
              "crashes", "restarts", "restarts_in_window", "implicated")},
          "memory_allocated": {"before_crash": mem0,
                               "at_restart": mem_restart, "after": mem1},
          "survivor_health_states": sorted(set(states)),
          "extra_attempts": st["extra_attempts"], **perf, "k6": k6,
          "new_tokens_at_most": ROUTER_FAULT_TOKENS,
          "equal_to_serve": same(outs, bf16_outputs), "card": kind})
    del router, sups, chaos, rrs
    free()

    # 3. r0's breaker opens under a crash storm: the prober ejects it,
    # the requests it held are retried on r1, /healthz stays 200
    storm = threading.Event()
    sups = _router_fleet(model, shape, [{"max_restarts": 1}, {}], engines)
    chaos = SupervisedChaos(sups[0], arm=lambda m: m.crash_storm(1.0)
                            if storm.is_set() else None)
    router = in_process(sups)
    front = RouterHTTPServer(router, port=0)
    base = f"http://127.0.0.1:{front.port}"
    probes, done = [], threading.Event()

    def poll_front():
        while not done.is_set():
            code, _, body = _http(base, "/healthz")
            probes.append((code, json.loads(body)["status"]))
            done.wait(ROUTER_POLL_S)

    poller = threading.Thread(target=poll_front)
    poller.start()
    rrs, t0 = run(router, faulty)
    _wait(lambda: sups[0].engine._steps >= ROUTER_CRASH_STEP,
          "r0's decode steps")
    held = sups[0].busy_slots() + len(sups[0].scheduler)
    storm.set()
    chaos.current.crash_storm(1.0)
    _wait(lambda: router.replicas()[0]["state"] == "ejected",
          "r0's ejection")
    outs, perf = finish("router_serve failover", rrs, t0, faulty)
    done.set()
    poller.join()
    st = router.stats()
    rows = {r["name"]: r for r in st["replicas"]}
    cfg_r = router.config
    cap = cfg_r.retry_amplification_cap * st["requests"] \
        + cfg_r.retry_amplification_floor
    k6 = _router_launches("router_serve failover", engines, L, "bfloat16")
    retried = sum(rr.retries > 0 for rr in rrs)
    check(sups[0].broken and chaos.injected["crash"] == 2,
          f"router_serve: failover: breaker {sups[0].broken}, injected "
          f"{chaos.injected}")
    check(rows["r0"]["state"] == "ejected" and rows["r0"]["ejections"] == 1
          and rows["r0"]["probe_failures"] >= cfg_r.probe_failures_to_eject
          and rows["r1"]["state"] == "healthy",
          f"router_serve: replicas after the storm {rows}")
    check(retried >= 1 and 1 <= st["extra_attempts"] <= cap and
          all(rr.replica == "r1" for rr in rrs if rr.retries),
          f"router_serve: {retried} requests retried, {st['extra_attempts']}"
          f" extra attempts against a cap of {cap}")
    check(probes and set(probes) == {(200, "ok")},
          f"router_serve: the router's /healthz read {sorted(set(probes))}")
    front.stop()
    router.stop(drain=True, timeout_s=60)
    emit({"phase": "router_serve", "part": "failover",
          "held_by_r0_at_storm": held, "retried_requests": retried,
          "extra_attempts": st["extra_attempts"], "amplification_cap": cap,
          "r0": {k: rows["r0"][k] for k in (
              "state", "ejections", "probe_failures", "attempts")},
          "healthz_probes": len(probes), **perf, "k6": k6,
          "new_tokens_at_most": ROUTER_FAULT_TOKENS,
          "equal_to_serve": same(outs, bf16_outputs), "card": kind})
    del router, front, sups, chaos, rrs
    free()

    # 4. a poison request, armed on both replicas: quarantined after two
    # crashes fleet-wide (its probe admitted alone), refused on resubmit,
    # the other eleven complete
    pi = len(requests) - 1            # the 48-token request
    pp, pm = requests[pi]
    fp = request_fingerprint(np.asarray(pp, np.int32),
                             SamplingParams(max_new_tokens=pm))
    sups = _router_fleet(model, shape, [{}, {}], engines)
    chaoses = [SupervisedChaos(s, arm=lambda m: m.poison_fingerprint(fp))
               for s in sups]
    router = in_process(sups)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poison = router.submit(pp, max_new_tokens=pm)
    _wait(lambda: sum(c.injected["poison"] for c in chaoses) >= 1,
          "the poison's first crash")
    others = [r for i, r in enumerate(faulty) if i != pi]
    rrs = [router.submit(p, max_new_tokens=m) for p, m in others]
    poison.result(timeout=HTTP_TIMEOUT)
    outs, perf = finish("router_serve poison", rrs, t0, others)
    fired = sum(c.injected["poison"] for c in chaoses)
    hit = [i for i, s in enumerate(sups) if s.quarantined]
    check(poison.status == "failed" and POISON_MARKER in poison.error and
          fp in poison.error and fired == 2 and poison.retries == 0,
          f"router_serve: poison ended {poison.status} ({poison.error}), "
          f"fired {fired} times")
    check(len(hit) == 1 and sups[hit[0]].quarantined == [fp] and
          sups[hit[0]].supervisor_stats()["implicated"] == {fp: 2} and
          sum(s.restarts for s in sups) == 2,
          f"router_serve: quarantine {[s.supervisor_stats() for s in sups]}")
    try:
        router.submit(pp, max_new_tokens=pm)
        refused = None
    except PoisonedRequestError as e:
        refused = e.fingerprint
    check(refused == fp, f"router_serve: the resubmitted poison gave "
                         f"{refused}")
    k6 = _router_launches("router_serve poison", engines, L, "bfloat16")
    router.stop(drain=True, timeout_s=60)
    emit({"phase": "router_serve", "part": "poison", "fingerprint": fp,
          "poison_request": pi, "crashes_fleet_wide": fired,
          "restarts": [s.restarts for s in sups],
          "implicated": sups[hit[0]].supervisor_stats()["implicated"],
          "refused_on_resubmit": True, "innocents": len(rrs), **perf,
          "k6": k6, "card": kind})
    del router, sups, chaoses, rrs, poison
    free()

    # 5. over HTTP: two supervised engines behind ServingHTTPServer, two
    # HTTPReplicas, the router's own front end
    extra = list(np.random.RandomState(SEED + 15).randint(
        1, cfg.vocab_size, ROUTER_POISON))
    efp = request_fingerprint(np.asarray(extra, np.int32),
                              SamplingParams(max_new_tokens=4))
    sups = _router_fleet(model, shape, [{}, {}], engines)
    chaoses = [SupervisedChaos(s, arm=lambda m: m.poison_fingerprint(efp))
               for s in sups]
    da.reset_counters()
    for s in sups:
        s.warmup()
    check(_build.total_builds() == builds0,
          "router_serve: a replica's warmup built a kernel library")
    servers = [ServingHTTPServer(s, port=0) for s in sups]
    router = Router([HTTPReplica(f"http://127.0.0.1:{h.port}", name=f"r{i}")
                     for i, h in enumerate(servers)], RouterConfig(seed=0))
    front = RouterHTTPServer(router, port=0)
    base = f"http://127.0.0.1:{front.port}"

    def completed(fams, replica):
        return sum(s["value"] for s in
                   fams["paddle_tpu_serving_requests_total"]["samples"]
                   if s["labels"].get("outcome") == "completed" and
                   s["labels"].get("replica") == replica)

    def federated():
        time.sleep(router.config.stats_refresh_s + 0.05)  # scrapes due
        return exporters.parse_prometheus_text(
            _http(base, "/metrics")[2].decode())

    fams0 = federated()
    probes, replica_states, done = [], [], threading.Event()

    def poll_http():
        while not done.is_set():
            code, _, body = _http(base, "/healthz")
            probes.append((code, json.loads(body)["status"]))
            for h in servers:
                replica_states.append(json.loads(_http(
                    f"http://127.0.0.1:{h.port}", "/healthz")[2])["status"])
            done.wait(ROUTER_POLL_S)

    poller = threading.Thread(target=poll_http)
    poller.start()
    results = [None] * len(requests)
    clients = [threading.Thread(target=_http_client, args=(
        base, p, m, i % 2 == 1, results, i))
        for i, (p, m) in enumerate(requests)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    secs = time.perf_counter() - t0
    done.set()
    poller.join()
    for i, ((p, m), res) in enumerate(zip(requests, results)):
        rec = res.get("record") or {}
        check(res.get("code") == 200 and rec.get("status") == "completed"
              and len(rec.get("tokens", ())) == m,
              f"router_serve http: request {i} answered {res}")
        if res["streamed"] is not None:
            check(res["streamed"] == rec["tokens"],
                  f"router_serve http: request {i}'s stream differs from "
                  f"its record")
    https = [r["record"]["tokens"] for r in results]
    gen = sum(map(len, https))
    check(probes and set(probes) == {(200, "ok")} and
          "stalled" not in replica_states,
          f"router_serve http: router /healthz read {sorted(set(probes))}, "
          f"the replicas {sorted(set(replica_states))}")
    rows = json.loads(_http(base, "/replicas")[2])["replicas"]
    check(sorted(r["name"] for r in rows) == ["r0", "r1"],
          f"router_serve http: /replicas {rows}")
    fams1 = federated()
    # both replicas live in this process: each one's /metrics is the
    # process registry, so each replica series rises by the whole
    # traffic and the fleet roll-up by their sum (as in the JAX package)
    rise = {r: completed(fams1, r) - completed(fams0, r)
            for r in ("r0", "r1", "fleet")}
    check(rise == {"r0": len(requests), "r1": len(requests),
                   "fleet": 2 * len(requests)},
          f"router_serve http: completed requests rose by {rise}")
    slo = json.loads(_http(base, "/slo")[2])
    check(set(slo["objectives"]) == {"availability", "goodput", "ttft_p95"}
          and slo["observed"] >= len(requests),
          f"router_serve http: /slo {slo}")
    rid = results[0]["record"]["request_id"]
    merged = json.loads(_http(base, f"/trace?request={rid}")[2])
    lanes = [ev["args"]["name"] for ev in merged["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"]
    check(f"router request {rid}" in lanes and
          any(n.startswith("attempt ") for n in lanes),
          f"router_serve http: merged trace lanes {lanes}")
    k6 = _router_launches("router_serve http", engines, L, "bfloat16")
    # the poisoned extra request: 400 quarantined mid-flight, then at
    # the router's door
    code, _, body = _http(base, "/generate", {
        "prompt": [int(t) for t in extra], "max_new_tokens": 4})
    q1 = json.loads(body)
    code2, _, body2 = _http(base, "/generate", {
        "prompt": [int(t) for t in extra], "max_new_tokens": 4})
    q2 = json.loads(body2)
    for c, q in ((code, q1), (code2, q2)):
        check(c == 400 and q.get("quarantined") is True and
              q.get("retriable") is False and q.get("fingerprint") == efp,
              f"router_serve http: the poisoned request answered {c} {q}")
    # the poison's last crash restarts its replica, and a drain that
    # arrives during a restart reaches the dead engine (as in the JAX
    # supervisor; ROADMAP C9): the fleet settles first
    _wait(lambda: not any(s.restarting for s in sups),
          "the poison's restart")
    # SIGTERM: the preemption listener drains the fleet with four
    # requests in flight
    install_sigterm_drain(router)
    drain_out = [None] * 4
    clients = [threading.Thread(target=_http_client, args=(
        base, p, HTTP_DRAIN_TOKENS, False, drain_out, i))
        for i, (p, _) in enumerate(requests[:4])]
    for c in clients:
        c.start()
    _wait(lambda: sum(s.busy_slots() + len(s.scheduler) for s in sups) >= 4,
          "the drain's requests")
    request_preemption()
    for c in clients:
        c.join()
    _wait(lambda: router_health(router)[1]["status"] == "stopped",
          "the fleet drain")
    hcode, _, hbody = _http(base, "/healthz")
    hstatus = json.loads(hbody)["status"]
    uninstall_sigterm_drain(router)
    clear_preemption()
    uninstall_preemption_handler()
    check(all(r["code"] == 200 and r["record"]["status"] == "completed"
              and len(r["record"]["tokens"]) == HTTP_DRAIN_TOKENS
              for r in drain_out),
          f"router_serve http: the drained requests ended {drain_out}")
    check(hcode == 503 and hstatus in ("draining", "stopped") and
          all(s.draining or s.stopped for s in sups),
          f"router_serve http: after SIGTERM /healthz {hcode} {hstatus}, "
          f"replicas {[s.health()[1]['status'] for s in sups]}")
    front.stop()
    router.stop()
    for h, s in zip(servers, sups):
        h.stop()
        s.stop()
    http_row = {"seconds": secs, "generated_tokens": gen,
                "tokens_per_s": gen / secs,
                "ttft_s": _p50_p95([r["record"]["ttft_s"] for r in results]),
                "tpot_s": _p50_p95([r["record"]["tpot_s"] for r in results]),
                "client_seconds": _p50_p95([r["seconds"] for r in results])}
    emit({"phase": "router_serve", "part": "http", "requests": len(requests),
          "streamed": sum(r["streamed"] is not None for r in results),
          "per_replica": {r: sum(x["record"]["replica"] == r
                                 for x in results) for r in ("r0", "r1")},
          **http_row, "k6": k6, "completed_rise": rise,
          "healthz_probes": len(probes),
          "replica_health_states": sorted(set(replica_states)),
          "trace_lanes": lanes, "quarantined_answers": [code, code2],
          "poison_restarts": [s.restarts for s in sups],
          "sigterm": {"in_flight": 4, "healthz_after": [hcode, hstatus]},
          "http_serve_single_engine": refs["http"],
          "equal_to_serve": sum(a == b for a, b in zip(https, bf16_outputs)),
          "card": kind})
    del router, front, servers, sups, chaoses
    free()

    # 6. fp32 at full width and depth 2: the requests through a warm
    # restart of r0 mid-decode (its suspects replayed alone on the new
    # engine) and the breaker of r1 (mid-decode, then at the rebuilt
    # engine's first step, which holds no request: nothing is implicated
    # twice), whose requests fail over to r0; bit-equal to one engine
    cfg2 = LlamaConfig.llama2_7b(dtype="float32")
    cfg2.num_hidden_layers = 2
    small = seeded_llama(cfg2, SEED, DEV, torch.float32).eval()
    reqs32 = [(p, ROUTER_FP32_TOKENS) for p in prompts]
    eng = ServingEngine(small, ServingConfig(**shape), device=DEV)
    want = [eng.submit(p, max_new_tokens=m) for p, m in reqs32]
    eng.run_until_idle()
    want = [list(r.output_tokens) for r in want]
    del eng

    def crashes(*after):
        """Arm engine generation g to crash after ``after[g]`` steps."""
        gens = itertools.count()

        def arm(m):
            g = next(gens)
            if g < len(after):
                m.crash_after_steps(after[g])
        return arm

    sups = _router_fleet(small, shape, [{}, {"max_restarts": 1}], engines)
    router = in_process(sups)
    # armed just before the traffic: an idle loop steps too
    chaos = [SupervisedChaos(sups[0], arm=crashes(12)),
             SupervisedChaos(sups[1], arm=crashes(14, 0))]
    rrs, t0 = run(router, reqs32)
    _wait(lambda: sups[1].broken, "r1's breaker")
    outs, perf = finish("router_serve fp32", rrs, t0, reqs32)
    k6 = _router_launches("router_serve fp32", engines, 2, "float32")
    equal = [a == b for a, b in zip(outs, want)]
    check(all(equal), f"router_serve fp32: requests "
                      f"{[i for i, e in enumerate(equal) if not e]} differ "
                      f"from one engine's tokens")
    injected = [c.injected["crash"] for c in chaos]
    retried = sum(rr.retries > 0 for rr in rrs)
    check(injected == [1, 2] and sups[0].restarts == 1 and
          not sups[0].broken and sups[1].broken and retried >= 1 and
          not (sups[0].quarantined or sups[1].quarantined),
          f"router_serve fp32: injected {injected}, restarts "
          f"{[s.restarts for s in sups]}, retries "
          f"{[rr.retries for rr in rrs]}")
    router.stop(drain=True, timeout_s=60)
    emit({"phase": "router_serve", "part": "fp32 depth 2",
          "requests": len(rrs), "equal_to_one_engine": sum(equal),
          "restarts": [s.restarts for s in sups], "crashes": injected,
          "retried_requests": retried,
          "replicas_finishing": sorted({rr.replica for rr in rrs}),
          **perf, "k6": k6, "card": kind})
    del router, sups, chaos, rrs, small
    free()
    check(_build.total_builds() == builds0,
          "router_serve: the phase built a kernel library")
    emit({"phase": "router_serve", "part": "done",
          "phase_seconds": time.perf_counter() - t_phase})
    return router_launches


def _full_accept(n_new, depth):
    """Drafts a request accepts over its rounds when every proposal
    matches: each round drafts min(depth, remaining - 1) and emits one
    more (the root's own token)."""
    r, acc = n_new - 1, 0
    while r > 0:
        dc = min(depth, r - 1)
        acc += dc
        r -= dc + 1
    return acc


def spec_parity_phase(kind):
    """Llama-2-7B's width at depth 2 in fp32 with a 1-layer truncated
    draft, three requests: the chain (k 4), [2, 2] and [4, 2, 2] lanes on
    the card and on the CPU (plain versions), an int8 [2, 2] lane, and
    offline ``generate`` chain and tree. Asserts: the card's speculative
    tokens equal its plain engine's (and plain ``generate``'s); card and
    CPU tokens equal; per-request drafted and accepted counts equal on
    card and CPU; a coupled pair (the target's layer 1 zeroed to an
    identity, the draft its first layer) accepts every draft."""
    import numpy as np
    import torch

    from paddle_tpu_torch.generation import generate, truncated_draft
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import convert_for_serving
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = seeded_llama(cfg, SEED + 5, "cpu", torch.float32).eval()
    gpu = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32).eval()
    gpu.load_state_dict(cpu.state_dict())
    models = {"cuda": (gpu, truncated_draft(gpu, 1)),
              "cpu": (cpu, truncated_draft(cpu, 1))}
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (40, 200, 90)]
    new = [6, 6, 6]

    def serve(model, draft, dev, n_req=3, sampling=None, **ov):
        eng = ServingEngine(model, ServingConfig(
            max_slots=2, max_len=512, block_size=16, prefill_chunk=128,
            **ov), device=dev, draft_model=draft)
        sampling = sampling or [{}] * n_req
        reqs = [eng.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in zip(prompts[:n_req], new, sampling)]
        eng.run_until_idle()
        check(all(r.status == "completed" for r in reqs),
              f"spec_parity: {dev} engine left requests unfinished")
        return ([list(r.output_tokens) for r in reqs],
                [(r.spec_drafted, r.spec_accepted) for r in reqs])

    plain = serve(gpu, None, DEV)[0]
    result = {"plain_tokens_cuda": plain}
    da.reset_counters()
    for label, ov in (("chain k4", dict(spec_k=4)),
                      ("tree [2,2]", dict(spec_tree=(2, 2))),
                      ("tree [4,2,2]", dict(spec_tree=(4, 2, 2)))):
        runs = {dev: serve(m, d, DEV if dev == "cuda" else "cpu", **ov)
                for dev, (m, d) in models.items()}
        result[label] = {"tokens_equal_plain": runs["cuda"][0] == plain,
                         "tokens_equal_card_cpu":
                             runs["cuda"][0] == runs["cpu"][0],
                         "drafted_accepted_cuda": runs["cuda"][1],
                         "drafted_accepted_cpu": runs["cpu"][1]}
        check(runs["cuda"][0] == plain,
              f"spec_parity {label}: card spec tokens {runs['cuda'][0]} != "
              f"card plain tokens {plain}")
        check(runs["cuda"] == runs["cpu"],
              f"spec_parity {label}: card {runs['cuda']} != CPU "
              f"{runs['cpu']}")
    result["kernel_launches_cuda"] = {k: v for k, v in da.LAUNCHES.items()
                                      if v}
    check(da.LAUNCHES["paged_flash_decode_attention_tree"] > 0,
          "spec_parity: the fp32 tree lanes did not run K8")

    # sampled lanes on the card: the three samplers of SAMPLE_CYCLE, one
    # a request; the speculative tokens equal the plain sampled engine's
    sp = [dict(SAMPLE_CYCLE[1 + i], seed=100 + i) for i in range(3)]
    splain = serve(gpu, None, DEV, sampling=sp)[0]
    result["plain_sampled_tokens_cuda"] = splain
    for label, ov in (("chain k4 sampled", dict(spec_k=4)),
                      ("tree [2,2] sampled", dict(spec_tree=(2, 2)))):
        toks, counts = serve(gpu, models["cuda"][1], DEV, sampling=sp, **ov)
        result[label] = {"tokens_equal_plain": toks == splain,
                         "drafted_accepted_cuda": counts}
        check(toks == splain,
              f"spec_parity {label}: card spec tokens {toks} != card plain "
              f"sampled tokens {splain}")

    # int8 weights and KV, tree [2, 2]: both devices from the CPU's
    # converted weights (two requests, four new tokens)
    q = {}
    for name, dev in (("cpu", "cpu"), ("cuda", DEV)):
        t = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32).eval()
        t.load_state_dict(cpu.state_dict())
        d = truncated_draft(t, 1)
        convert_for_serving(t, fmt="int8")
        convert_for_serving(d, fmt="int8")
        if name == "cuda":
            t.load_state_dict(q["cpu"][0].state_dict())
            d.load_state_dict(q["cpu"][1].state_dict())
        q[name] = (t, d, dev)
    n_int8 = 2
    saved = new[:]
    new[:] = [4, 4, 4]
    iq = {name: serve(t, d, dev, n_req=n_int8, spec_tree=(2, 2),
                      kv_format="int8")
          for name, (t, d, dev) in q.items()}
    iplain = serve(q["cuda"][0], None, DEV, n_req=n_int8,
                   kv_format="int8")[0]
    new[:] = saved
    result["int8 tree [2,2]"] = {
        "tokens_equal_plain": iq["cuda"][0] == iplain,
        "tokens_equal_card_cpu": iq["cuda"][0] == iq["cpu"][0],
        "drafted_accepted_cuda": iq["cuda"][1]}
    check(iq["cuda"][0] == iplain,
          f"spec_parity int8: card spec {iq['cuda'][0]} != plain {iplain}")
    check(iq["cuda"] == iq["cpu"],
          f"spec_parity int8: card {iq['cuda']} != CPU {iq['cpu']}")
    del q, iq

    # offline generate: two 40-token prompts, chain and tree
    ids = [prompts[0][:40], prompts[2][:40]]
    gen, gen_launches = {}, {}
    for dev, (m, d) in models.items():
        for mode, kw in (("plain", {}),
                         ("chain", dict(draft_model=d, spec_k=4)),
                         ("tree", dict(draft_model=d, spec_tree=(2, 2)))):
            da.reset_counters()
            gen[dev, mode] = generate(m, ids, max_new_tokens=6,
                                      **kw).tolist()
            gen_launches[dev, mode] = {k: v for k, v in da.LAUNCHES.items()
                                       if v}
    # the chain's draft steps and verify bundles (q_len 5) run K4 on the
    # contiguous caches; the tree's bundles take the plain attention
    check(gen_launches["cuda", "chain"].get("flash_decode_attention", 0) > 0,
          f"spec_parity: generate chain ran no K4: {gen_launches}")
    for mode in ("chain", "tree"):
        result[f"generate {mode}"] = {
            "equal_plain": gen["cuda", mode] == gen["cuda", "plain"],
            "equal_card_cpu": gen["cuda", mode] == gen["cpu", mode],
            "kernel_launches_cuda": gen_launches["cuda", mode]}
        check(gen["cuda", mode] == gen["cuda", "plain"]
              and gen["cuda", mode] == gen["cpu", mode],
              f"spec_parity generate {mode}: {gen}")

    # coupled pair on the card: layer 1 an exact identity, the draft the
    # target's first layer; greedy accepts every proposal
    with torch.no_grad():
        gpu.llama.layers[1].self_attn.o_proj.weight.zero_()
        gpu.llama.layers[1].mlp.down_proj.weight.zero_()
    cdraft = truncated_draft(gpu, 1)
    for label, ov, depth in (("chain k4", dict(spec_k=4), 4),
                             ("tree [2,2]", dict(spec_tree=(2, 2)), 2)):
        toks, counts = serve(gpu, cdraft, DEV, **ov)
        want = [_full_accept(n, depth) for n in new]
        result[f"coupled {label}"] = {"drafted_accepted": counts,
                                      "accepted_if_every_draft_matches": want}
        if "spec_k" in ov:
            ok = all(dr == ac for dr, ac in counts)
        else:
            ok = [ac for _, ac in counts] == want
        check(ok, f"spec_parity coupled {label}: drafts rejected: "
                  f"{counts} (full accept: {want})")
    emit({"phase": "spec_parity", "dtype": "float32", "layers": 2,
          "draft_layers": 1, "requests": len(prompts), "new_tokens": new,
          **result, "card": kind})
    del models, gpu, cpu, cdraft
    torch.cuda.empty_cache()


# the engine's final prefill chunk past max_len: a 56-token prompt in
# chunks of 48 against max_len 64, so the second chunk's padded end (96)
# passes the slot's 4 blocks
EDGE_SERVING = dict(max_slots=1, max_len=64, block_size=16, prefill_chunk=48,
                    num_blocks=10)


def edge_phase(kind):
    """The engine's last chunk past max_len, Llama-2-7B's width at depth
    2 in fp32 (positions up to 96 stay inside its rope table): the card's
    engine tokens equal the card's ``generate`` and the CPU engine's, its
    chunks ran on the fp32 tiles and its decode steps on the rows body.
    Then the paged kernel at that chunk's shape (q_len 48 at pos 48 over
    the slot's 4 blocks and its 3 dump-block columns), fp32 (SIMT) and
    bf16 (tensor cores), against its plain version. Returns the kernel
    rows."""
    import numpy as np
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = seeded_llama(cfg, SEED + 7, "cpu", torch.float32).eval()
    gpu = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32).eval()
    gpu.load_state_dict(cpu.state_dict())
    prompt = np.random.RandomState(3).randint(1, cfg.vocab_size, 56).tolist()
    toks, bodies, chunks = {}, {}, {}
    for name, model, dev in (("cuda", gpu, DEV), ("cpu", cpu, "cpu")):
        eng = ServingEngine(model, ServingConfig(**EDGE_SERVING), device=dev)
        da.reset_counters()
        req = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_idle()
        check(req.status == "completed",
              f"edge: the {name} engine left the request unfinished")
        toks[name] = list(req.output_tokens)
        bodies[name] = dict(da.BODY_LAUNCHES)
        chunks[name] = eng.stats()["prefill_chunks"]
        steps = eng.stats()["steps"]
        del eng
    gen = generate(gpu, [prompt], max_new_tokens=6)[0, 56:].tolist()
    L = cfg.num_hidden_layers
    check_bodies("edge cuda engine", bodies["cuda"], {
        "paged_flash_decode_attention/tiled": L * chunks["cuda"],
        "paged_flash_decode_attention/rows": L * steps})
    rows = []
    dev = torch.device(DEV)
    H, bs = cfg.num_attention_heads, 16
    d = cfg.hidden_size // H
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    bt = torch.tensor([[3, 7, 1, 5, 0, 0, 0]], dtype=torch.int32, device=dev)
    pos = torch.tensor([48], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, kp, vp = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((1, 48, H, d), (10, bs, H, d),
                                   (10, bs, H, d)))
        da.reset_counters()
        got = da.paged_flash_decode_attention(q, kp, vp, bt, pos)
        want = da.paged_flash_decode_attention_ref(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        row = {"phase": "kernel", "name": "paged_flash_decode_attention",
               "case": "last chunk past max_len", "dtype": dname, "B": 1,
               "q_len": 48, "heads": H, "kv_heads": H, "group": 1,
               "body": da.bundle_body(48, 1, dtype), "head_dim": d,
               "block_table": bt.tolist(), "pos": [48],
               "launched": dict(da.BODY_LAUNCHES), "max_abs_err": err,
               "atol": ATOL[dname], "ok": err <= ATOL[dname]}
        emit(row)
        rows.append(row)
        check(row["ok"], f"edge kernel disagrees with its plain version: "
                         f"{json.dumps(row)}")
    emit({"phase": "edge", "dtype": "float32", "layers": 2,
          "serving": EDGE_SERVING, "prompt_len": len(prompt), "new_tokens": 6,
          "tokens_cuda": toks["cuda"], "tokens_cpu": toks["cpu"],
          "generate_cuda": gen, "prefill_chunks": chunks["cuda"],
          "kernel_bodies_cuda": bodies["cuda"], "card": kind})
    check(toks["cuda"] == gen == toks["cpu"],
          f"edge: card engine {toks['cuda']}, card generate {gen}, CPU "
          f"engine {toks['cpu']} differ")
    del gpu, cpu
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# quantized serving: K5, K7 (dequantizing flash decode) and K9 (quant matmul)
# ---------------------------------------------------------------------------

QUANT_FORMATS = ("int8", "fp8")
# Llama-2-7B's (N, K) of q/k/v/o_proj, gate/up_proj, down_proj and lm_head
QMM_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
# a decode step of 8 slots, the int8 [2,2] and [4,2,2] verify bundles of
# 8 slots (7 and 29 nodes), a 128-token prefill chunk (an engine with
# prefill_chunk=128: the wgmma body's 128-token tile), a 256-token one
QMM_M = (8, 56, 128, 232, 256)
HOST_CALLS = 100    # wrapper calls queued per host-time sample


def quantize_cache(t, fmt):
    """A cache or pool quantized per token per head: (narrow, f32 absmax
    scales [.., KV])."""
    from paddle_tpu_torch.quantization.intx import absmax_along, pack_absmax

    amax = absmax_along(t, -1)
    return pack_absmax(t, amax[..., None], fmt), amax


def quant_attention_phase(rng):
    """K5 and K7 against their plain versions (dequantize, then attend)
    at the serving shapes, int8 and fp8, bf16 and fp32; SDPA over the
    dequantized cache is the library yardstick."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.quantization.intx import unpack_absmax

    dev = torch.device(DEV)
    rows = []
    B, H, d, max_len, bs = 8, 32, 128, 2048, 16
    nb = max_len // bs
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        for fmt in QUANT_FORMATS:
            for kernel, q_lens in (("flash_decode_attention_quant", (1, 8)),
                                   ("paged_flash_decode_attention_quant",
                                    (1, 32, 256))):
                paged = kernel.startswith("paged")
                for q_len in q_lens:
                    for group in (1, 4):
                        KV = H // group
                        Bq = 1 if q_len == 256 else B
                        pos = rng.randint(0, max_len - q_len + 1, Bq)
                        pos[0] = max_len - q_len
                        if Bq > 2:
                            pos[1], pos[2] = 0, 0
                        pos_t = torch.tensor(pos, dtype=torch.int32,
                                             device=dev)
                        q = torch.randn(Bq, q_len, H, d, device=dev).to(dtype)
                        if paged:
                            N = Bq * nb + 1
                            kp, ksc = quantize_cache(torch.randn(
                                N, bs, KV, d, device=dev), fmt)
                            vp, vsc = quantize_cache(torch.randn(
                                N, bs, KV, d, device=dev), fmt)
                            perm = rng.permutation(N - 1)[:Bq * nb] + 1
                            bt_np = perm.reshape(Bq, nb).astype("int32")
                            if Bq > 2:
                                bt_np[2] = 0
                            bt = torch.tensor(bt_np, device=dev)
                            run = lambda: da.paged_flash_decode_attention(  # noqa
                                q, kp, vp, bt, pos_t, k_scale=ksc,
                                v_scale=vsc)
                            plain = lambda: da.paged_flash_decode_attention_ref(  # noqa
                                q, kp, vp, bt, pos_t, k_scale=ksc,
                                v_scale=vsc)
                            kc = da._take_blocks(kp, bt)
                            vc = da._take_blocks(vp, bt)
                            kcs = da._take_blocks(ksc, bt)
                            vcs = da._take_blocks(vsc, bt)
                            extra = bt.numel() * 4 + Bq * 4
                        else:
                            kc, kcs = quantize_cache(torch.randn(
                                Bq, max_len, KV, d, device=dev), fmt)
                            vc, vcs = quantize_cache(torch.randn(
                                Bq, max_len, KV, d, device=dev), fmt)
                            run = lambda: da.flash_decode_attention(  # noqa
                                q, kc, vc, pos_t, k_scale=kcs, v_scale=vcs)
                            plain = lambda: da.flash_decode_attention_ref(  # noqa
                                q, kc, vc, pos_t, k_scale=kcs, v_scale=vcs)
                            extra = Bq * 4
                        got = run()
                        want = plain()
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        ok = err <= ATOL[dname]
                        lens = [min(int(p) + q_len, max_len) for p in pos]
                        # library yardstick: SDPA over the cache dequantized
                        # beforehand, with the same ragged causal mask
                        kd = unpack_absmax(kc, kcs[..., None], fmt, dtype)
                        vd = unpack_absmax(vc, vcs[..., None], fmt, dtype)
                        qs = q.transpose(1, 2)
                        ks_, vs_ = kd.transpose(1, 2), vd.transpose(1, 2)
                        lens_t = torch.tensor(lens, device=dev)
                        qpos = (lens_t - q_len)[:, None] + torch.arange(
                            q_len, device=dev)[None, :]
                        mask = (torch.arange(max_len, device=dev)[
                            None, None, :] <= qpos[:, :, None])[:, None]
                        lib = lambda: F.scaled_dot_product_attention(  # noqa
                            qs, ks_, vs_, attn_mask=mask,
                            enable_gqa=group > 1)
                        bound, bound_by = attention_bound(
                            lens, q_len, H, KV, d, isz, extra, dname,
                            kv_itemsize=1, scale_bytes=4)
                        nbytes = attention_bytes(lens, q_len, H, KV, d, isz,
                                                 extra, kv_itemsize=1,
                                                 scale_bytes=4)
                        ms = cuda_ms(run, 50)
                        row = {"phase": "kernel", "name": kernel,
                               "kv_format": fmt, "dtype": dname, "B": Bq,
                               "q_len": q_len, "heads": H, "kv_heads": KV,
                               "group": group,
                               "body": da.bundle_body(q_len, group, dtype,
                                                      fmt),
                               "head_dim": d,
                               "max_len": max_len,
                               "block_size": bs if paged else None,
                               "pos": [int(p) for p in pos],
                               "max_abs_err": err, "atol": ATOL[dname],
                               "ok": ok, "ms": ms,
                               "gbs": nbytes / ms / 1e6,
                               "bound_share": bound / ms,
                               "plain_ms": cuda_ms(plain, 5),
                               "library_ms": cuda_ms(lib, 20),
                               "library": "F.scaled_dot_product_attention "
                                          "over the dequantized cache",
                               "bound_ms": bound, "bound_by": bound_by}
                        emit(row)
                        rows.append(row)
                        check(ok, f"{kernel} disagrees with its plain "
                                  f"version: {json.dumps(row)}")
    torch.cuda.empty_cache()
    return rows


# K8: (pool storage, query dtype) and the bundles: a causal chain of 5
# (held bit for bit against K6/K7 without a mask), the [2, 2] tree (7
# nodes) and the [4, 2, 2] tree (29): bf16 queries take the tensor cores'
# one 16-row tile and its wide tile, fp32 the SIMT rows and tiled bodies
TREE_POOLS = (("bf16", "bfloat16"), ("f32", "float32"), ("int8", "bfloat16"),
              ("fp8", "bfloat16"))
TREE_BUNDLES = ((None, 5), ((2, 2), 7), ((4, 2, 2), 29))


def tree_kernel_phase(rng):
    """K8 (the paged kernels under a draft tree's ancestor mask) against
    its plain version at Llama-2-7B's serving shapes (B 8, 32 heads, d
    128, group 1 and one group-4 case, max_len 2048, random positions),
    over bf16 and fp32 pools and int8 / fp8 pools with bf16 queries. A
    causal mask must give the maskless kernel's (K6 / K7) output bit for
    bit. Library yardstick: SDPA with the boolean mask over the pool
    gathered (and dequantized) beforehand, as the K6/K7 rows time it;
    the gather's own cost is reported beside it."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.generation import spec_tree_plan
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.quantization.intx import unpack_absmax

    dev = torch.device(DEV)
    rows = []
    B, H, d, max_len, bs = 8, 32, 128, 2048, 16
    nb = max_len // bs
    cases = [(pool, dn, tree, w, 1) for pool, dn in TREE_POOLS
             for tree, w in TREE_BUNDLES] + [("bf16", "bfloat16", (4, 2, 2),
                                              29, 4)]
    for pool, dname, tree, w, group in cases:
        dtype = getattr(torch, dname)
        isz = torch.empty((), dtype=dtype).element_size()
        KV = H // group
        anc = torch.ones(w, w, dtype=torch.bool).tril() if tree is None \
            else torch.from_numpy(spec_tree_plan(tree)["anc"])
        mask = anc[None].expand(B, w, w).contiguous().to(dev)
        pos = rng.randint(0, max_len - w + 1, B)
        pos[0], pos[1] = max_len - w, 0
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = torch.randn(B, w, H, d, device=dev).to(dtype)
        N = B * nb + 1
        if pool in ("int8", "fp8"):
            kp, ksc = quantize_cache(torch.randn(N, bs, KV, d, device=dev),
                                     pool)
            vp, vsc = quantize_cache(torch.randn(N, bs, KV, d, device=dev),
                                     pool)
            scales = dict(k_scale=ksc, v_scale=vsc)
        else:
            kp = torch.randn(N, bs, KV, d, device=dev).to(dtype)
            vp = torch.randn(N, bs, KV, d, device=dev).to(dtype)
            scales = {}
        bt = torch.tensor((rng.permutation(N - 1)[:B * nb] + 1)
                          .reshape(B, nb).astype("int32"), device=dev)
        run = lambda: da.paged_flash_decode_attention(  # noqa
            q, kp, vp, bt, pos_t, ancestor_mask=mask, **scales)
        plain = lambda: da.paged_flash_decode_attention_ref(  # noqa
            q, kp, vp, bt, pos_t, ancestor_mask=mask, **scales)
        got = run()
        want = plain()
        nomask = da.paged_flash_decode_attention(q, kp, vp, bt, pos_t,
                                                 **scales)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= ATOL[dname]
        bitwise = bool(torch.equal(got, nomask)) if tree is None else None

        def gather():
            kc, vc = da._take_blocks(kp, bt), da._take_blocks(vp, bt)
            if scales:
                kc = unpack_absmax(kc, da._take_blocks(ksc, bt)[..., None],
                                   pool, dtype)
                vc = unpack_absmax(vc, da._take_blocks(vsc, bt)[..., None],
                                   pool, dtype)
            return kc.transpose(1, 2), vc.transpose(1, 2)

        ks_, vs_ = gather()
        lens = [min(int(p) + w, max_len) for p in pos]
        # the ancestor mask over the gathered cache
        am = da.ancestor_visibility(torch.tensor(lens, device=dev) - w,
                                    mask, max_len)[:, None]
        qs = q.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(  # noqa
            qs, ks_, vs_, attn_mask=am, enable_gqa=group > 1)
        lib_gather = lambda: F.scaled_dot_product_attention(  # noqa
            qs, *gather(), attn_mask=am, enable_gqa=group > 1)
        quant = bool(scales)
        bound, bound_by = attention_bound(
            lens, w, H, KV, d, isz, bt.numel() * 4 + B * 4 + mask.numel(),
            dname, kv_itemsize=1 if quant else None,
            scale_bytes=4 if quant else 0,
            bundle_pairs=int(anc.sum()))
        row = {"phase": "kernel",
               "name": "paged_flash_decode_attention_tree"
                       + ("_quant" if quant else ""),
               "kv_format": pool if quant else "bf16", "pool": pool,
               "dtype": dname, "tree": list(tree) if tree else "causal",
               "B": B, "q_len": w, "heads": H, "kv_heads": KV,
               "group": group,
               "body": da.bundle_body(w, group, dtype,
                                      pool if quant else "bf16"),
               "head_dim": d, "max_len": max_len,
               "block_size": bs, "pos": [int(p) for p in pos],
               "max_abs_err": err, "atol": ATOL[dname], "ok": ok,
               "causal_mask_bitwise_equal_to_no_mask": bitwise,
               "ms": cuda_ms(run, 50), "plain_ms": cuda_ms(plain, 5),
               "library_ms": cuda_ms(lib, 20),
               "library": "F.scaled_dot_product_attention with the boolean "
                          "mask over the pool gathered"
                          + (" and dequantized" if quant else "")
                          + " beforehand",
               "library_with_gather_ms": cuda_ms(lib_gather, 10),
               "bound_ms": bound, "bound_by": bound_by}
        emit(row)
        rows.append(row)
        check(ok, f"K8 disagrees with its plain version: {json.dumps(row)}")
        check(bitwise is not False,
              f"K8 with a causal mask differs from the maskless kernel: "
              f"{json.dumps(row)}")
        del kp, vp, ks_, vs_
    torch.cuda.empty_cache()
    return rows


# the split counts launch_plan chooses between, at the shapes of the
# serving path: (label, B, q_len, pool, tree, group); the bundles run the
# tensor-core body, the int8 and bf16 decode steps flash_decode_qrows
# (Llama-2-7B's group 1, and the GQA groups its rows hold) over two kinds
# of rows: "engine" as the served traffic's decode iteration holds them
# (the first eight prompts of TRAFFIC, every slot taken: the main path),
# "ragged" as the kernel rows draw them (two of eight empty)
SPLIT_SHAPES = (("chunk", 1, 256, "bf16", None, 1),
                ("chunk", 1, 256, "int8", None, 1),
                ("[4,2,2]", 8, 29, "bf16", (4, 2, 2), 1),
                ("[4,2,2]", 8, 29, "int8", (4, 2, 2), 1),
                ("[2,2]", 8, 7, "bf16", (2, 2), 1)) + tuple(
    (f"decode {rows}", 8, 1, pool, None, group) for pool in ("int8", "bf16")
    for group in (1, 2, 4, 8) for rows in ("engine", "ragged"))


def split_sweep_phase(rng):
    """The tensor-core body (bundles; 1 to 8 splits) and the decode
    step's body (int8 and bf16 pools, groups 1 to 8; 1 to 32 splits)
    under forced split counts at Llama-2-7B's shapes, each output against
    the plain version: the measurement behind ``launch_plan``'s split
    rules.
    Reports the split count the plan picks beside the times. The decode
    rows draw their tensors from a generator of their own, so the later
    phases' draws from the card's default generator are as before."""
    import torch

    from paddle_tpu_torch.generation import spec_tree_plan
    from paddle_tpu_torch.kernels import decode_attention as da

    dev = torch.device(DEV)
    H, d, max_len, bs = 32, 128, 2048, 16
    nb = max_len // bs
    planner = da.launch_plan
    own = torch.Generator(device=dev).manual_seed(SEED + 11)
    for label, B, w, pool, tree, group in SPLIT_SHAPES:
        KV = H // group
        pos = rng.randint(0, max_len - w + 1, B)
        pos[0] = max_len - w
        if label == "decode ragged":
            pos[1], pos[2] = 0, 0
        elif label == "decode engine":
            pos[:] = [n for n, _, _ in TRAFFIC[:B]]
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        g = own if label.startswith("decode") else None
        q = torch.randn(B, w, H, d, device=dev, generator=g) \
            .to(torch.bfloat16)
        N = B * nb + 1
        if pool == "int8":
            kp, ksc = quantize_cache(torch.randn(
                N, bs, KV, d, device=dev, generator=g), pool)
            vp, vsc = quantize_cache(torch.randn(
                N, bs, KV, d, device=dev, generator=g), pool)
            scales = dict(k_scale=ksc, v_scale=vsc)
        else:
            kp = torch.randn(N, bs, KV, d, device=dev, generator=g) \
                .to(torch.bfloat16)
            vp = torch.randn(N, bs, KV, d, device=dev, generator=g) \
                .to(torch.bfloat16)
            scales = {}
        bt = torch.tensor((rng.permutation(N - 1)[:B * nb] + 1)
                          .reshape(B, nb).astype("int32"), device=dev)
        mask = None if tree is None else torch.from_numpy(
            spec_tree_plan(tree)["anc"])[None].expand(B, w, w) \
            .contiguous().to(dev)
        run = lambda: da.paged_flash_decode_attention(  # noqa: E731
            q, kp, vp, bt, pos_t, ancestor_mask=mask, **scales)
        want = da.paged_flash_decode_attention_ref(
            q, kp, vp, bt, pos_t, ancestor_mask=mask, **scales)
        chosen = planner(w, group, torch.bfloat16, B, KV, max_len,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count, pool)
        times, errs = {}, []
        try:
            for n in (1, 2, 4, 8, 16, 32) if w == 1 else (1, 2, 4, 8):
                per = -(-max_len // 64 // n)
                forced = dict(chosen, n_split=-(-max_len // 64 // per),
                              split_keys=per * 64)
                da.launch_plan = lambda *a, _p=forced: _p  # noqa: E731
                errs.append((run().float() - want.float()).abs().max().item())
                times[forced["n_split"]] = cuda_ms(run, 30)
        finally:
            da.launch_plan = planner
        row = {"phase": "split_sweep", "bundle": label, "pool": pool, "B": B,
               "q_len": w, "group": group, "pos": [int(p) for p in pos],
               "body": chosen["body"], "rows": chosen["rows"],
               "plan_n_split": chosen["n_split"], "ms_by_n_split": times,
               "max_abs_err": max(errs), "atol": ATOL["bfloat16"]}
        emit(row)
        check(row["max_abs_err"] <= ATOL["bfloat16"],
              f"split sweep disagrees with the plain version: {row}")
        del kp, vp
    torch.cuda.empty_cache()


def qmm_bound(M, N, K, isz, dname):
    """Least time for one quantized matmul: the narrow weight, its
    scales, x and the output moved once, or 2*M*N*K operations at the
    activation dtype's peak, whichever is larger."""
    nbytes = N * K + N * 4 + M * K * isz + M * N * isz
    t_bytes = nbytes / PEAKS["bw"] * 1e3
    t_ops = 2 * M * N * K / PEAKS[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmm_rows(N, K, Ms, dtype, fmt, g, **tags):
    """K9 against its plain version for one (N, K) weight at each M of
    ``Ms``: the kernel's, the plain version's and the library
    yardstick's times, the bound and the body (with its plan). ``tags``
    are added to each row (``phase`` among them overrides "kernel")."""
    import torch

    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.quantization.intx import format_bound, pack_absmax

    dev = torch.device(DEV)
    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    rows = []
    wf = torch.randn(N, K, device=dev, generator=g)
    amax = wf.abs().amax(dim=1)
    w = pack_absmax(wf, amax[:, None], fmt)
    scale = amax / format_bound(fmt)
    wd = (w.to(dtype).float() * scale[:, None]).to(dtype)
    del wf
    # timed launches cycle through copies of the weight that together
    # exceed the L2, as the decode step's many different weights do
    ws = [w] + [w.clone() for _ in range(
        -(-2 * L2_BYTES // w.numel()) - 1)]
    wds = [wd] + [wd.clone() for _ in range(
        -(-2 * L2_BYTES // (wd.numel() * isz)) - 1)]
    iw, iwd = itertools.cycle(ws), itertools.cycle(wds)
    for M in Ms:
        # outputs near unit scale: atol covers a last-place flip
        x = (torch.randn(M, K, device=dev, generator=g)
             * (0.5 / K ** 0.5)).to(dtype)
        run = lambda: qm.quant_matmul(x, next(iw), scale)  # noqa: E731
        plain = lambda: qm.quant_matmul_ref(x, w, scale)  # noqa: E731
        lib = lambda: torch.matmul(x, next(iwd).t())  # noqa: E731
        got = qm.quant_matmul(x, w, scale)
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        bound, bound_by = qmm_bound(M, N, K, isz, dname)
        body = qm.qmm_body(M, dtype)
        plan = None
        if body == "wgmma":
            plan = qm.qmm_plan(M, N, K, qm._sm_count(dev))
        elif dtype == torch.bfloat16:
            plan = qm.gemv_plan(M, N, K, qm._sm_count(dev))
        row = {"phase": "kernel", "name": "quant_matmul",
               "weight_format": fmt, "dtype": dname, "M": M,
               "N": N, "K": K, "body": body, "plan": plan,
               "max_abs_err": err,
               "atol": ATOL[dname], "ok": err <= ATOL[dname],
               "ms": cuda_ms(run, 50),
               "plain_ms": cuda_ms(plain, 5),
               "library_ms": cuda_ms(lib, 20),
               "library": "torch.matmul(x, dequantized W.T)",
               "bound_ms": bound, "bound_by": bound_by}
        row["bound_share"] = bound / row["ms"]
        row.update(tags)
        emit(row)
        rows.append(row)
        check(row["ok"], f"quant_matmul disagrees with its plain "
                         f"version: {json.dumps(row)}")
    del w, wd, ws, wds
    return rows


def quant_matmul_phase():
    """K9 against its plain version at Llama-2-7B's linear shapes, a
    decode step (M 8), the verify bundles (M 56, 232) and prefill chunks
    (M 128, 256), int8 and fp8, bf16 and fp32; each row names the body it took
    and, for the wgmma body, its launch plan. The library yardstick is
    ``torch.matmul`` against the weight dequantized beforehand: the
    product K9 replaces."""
    import torch

    g = torch.Generator(device=torch.device(DEV)).manual_seed(SEED + 3)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for fmt in QUANT_FORMATS:
            for N, K in QMM_SHAPES:
                rows += qmm_rows(N, K, QMM_M, dtype, fmt, g)
    torch.cuda.empty_cache()
    return rows


def qmm_host_phase():
    """The K9 wrapper's host time per call at Llama-2-7B's four linear
    shapes, a decode step (M 8) and a prefill chunk (M 256), bf16 x and
    int8 weights: Python, ctypes and the launches, with the stream held
    by a spin kernel so that the calls queue and none waits for the card.
    An int8 prefill iteration makes 225 calls a chunk; where serving is
    host-bound, its wall time pays this. Only the public wrapper is
    called, so the phase times any tree's ``quant_matmul``."""
    import statistics

    import torch

    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.quantization.intx import format_bound, pack_absmax

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    for N, K in QMM_SHAPES:
        wf = torch.randn(N, K, device=dev, generator=g)
        amax = wf.abs().amax(dim=1)
        w = pack_absmax(wf, amax[:, None], "int8")
        scale = amax / format_bound("int8")
        for M in (8, 256):
            x = (torch.randn(M, K, device=dev, generator=g)
                 * (0.5 / K ** 0.5)).to(torch.bfloat16)
            qm.quant_matmul(x, w, scale)
            torch.cuda.synchronize()
            samples = []
            for _ in range(7):
                torch.cuda._sleep(HOLD_CYCLES * HOST_CALLS)
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    qm.quant_matmul(x, w, scale)
                samples.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
                torch.cuda.synchronize()
            emit({"phase": "host", "name": "quant_matmul",
                  "weight_format": "int8", "dtype": "bfloat16", "M": M,
                  "N": N, "K": K, "calls": HOST_CALLS, "samples": 7,
                  "host_us_median": statistics.median(samples),
                  "host_us_min": min(samples)})
        del w, wf
    torch.cuda.empty_cache()


def model_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def linears_per_layer(model):
    """Weight-only quantized linears a decoder layer of a converted model
    (Llama 7, GPT 6; the lm_head is the one left over)."""
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear

    n = sum(isinstance(m, WeightOnlyLinear) for m in model.modules())
    return (n - 1) // model.config.num_hidden_layers


def check_quant_serve(tag, model, requests, reqs, st, launches, fallbacks,
                      bodies, qmm, qmm_bodies, qmm_fb):
    """A quantized engine's run: every request completes with its token
    count; K7 launches exactly layers x (decode steps + prefill chunks),
    by body exactly (chunks on ``mma``, decode steps on ``qrows``), the
    unquantized paged kernel never; K9 exactly (linears a layer x layers
    + the lm_head) x forwards, chunks on ``wgmma`` and decode steps on
    the GEMV; no fallback. Returns the bodies."""
    L = model.config.num_hidden_layers
    per_forward = linears_per_layer(model) * L + 1
    for r, (p, m) in zip(reqs, requests):
        check(r.status == "completed" and len(r.output_tokens) == m,
              f"{tag}: request {r} did not complete with {m} tokens")
    forwards = st["steps"] + st["prefill_chunks"]
    k7 = launches["paged_flash_decode_attention_quant"]
    check(k7 == L * forwards,
          f"{tag}: K7 launched {k7} times, expected {L} x ({st['steps']} "
          f"steps + {st['prefill_chunks']} chunks) = {L * forwards}")
    check(launches["paged_flash_decode_attention"] == 0,
          f"{tag}: the unquantized paged kernel ran: {launches}")
    bodies = check_bodies(tag, bodies, {
        "paged_flash_decode_attention_quant/mma": L * st["prefill_chunks"],
        "paged_flash_decode_attention_quant/qrows": L * st["steps"]})
    check(not fallbacks, f"{tag}: attention fallbacks {fallbacks}")
    check(qmm["quant_matmul"] == per_forward * forwards,
          f"{tag}: K9 launched {qmm['quant_matmul']} times, expected "
          f"{per_forward} x {forwards} forwards")
    check(not qmm_fb, f"{tag}: quant_matmul fallbacks {qmm_fb}")
    # every prefill chunk's products (M 256) on the wgmma body, every
    # decode step's (M 8) on the GEMV
    want = {"quant_matmul/wgmma": per_forward * st["prefill_chunks"],
            "quant_matmul/gemv": per_forward * st["steps"]}
    check(qmm_bodies == {k: v for k, v in want.items() if v},
          f"{tag}: K9 bodies {qmm_bodies}, expected exactly {want}")
    return bodies


def serve_quant_phase(cfg, requests, bf16_outputs, bf16_tps, kind):
    """Llama-2-7B (the bf16 serve's seeded weights) converted by
    ``convert_for_serving`` to int8, served with int8 KV blocks over the
    same traffic: every request completes, K7 launches once per layer per
    iteration and K9 225 times per forward, with no fallback;
    ``generate(kv_format="int8")`` launches K5 once per layer per decode
    step. Reports tokens/s, KV bytes per token, model bytes, peak memory,
    agreement with the bf16 engine and teacher-forced agreement. Then
    the int8 speculative lane: tree [2, 2] with the 2-layer truncated
    draft (converted alike) over the same traffic (K7, K8's quantized
    variant and K9). Then the same in fp8 (weights and KV) on four
    requests. Returns the launch counts of the int8 serve, generate and
    spec runs."""
    import torch

    from paddle_tpu_torch.generation import truncated_draft
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.quantization import convert_for_serving

    result = {}
    for fmt, n_req in (("int8", len(requests)), ("fp8", 4)):
        reqs_in = requests[:n_req]
        model = seeded_llama(cfg, SEED, DEV, torch.bfloat16).eval()
        bf16_bytes = model_bytes(model)
        draft = truncated_draft(model, DRAFT_LAYERS) if fmt == "int8" \
            else None
        t0 = time.perf_counter()
        convert_for_serving(model, fmt=fmt)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        qm.reset_counters()
        eng, reqs, secs, launches, fallbacks, bodies = serve_engine(
            model, reqs_in, kv_format=fmt)
        qmm = dict(qm.LAUNCHES)
        qmm_bodies = dict(qm.BODY_LAUNCHES)
        qmm_fb = dict(qm.DISPATCH_FALLBACKS)
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated()
        tag = f"{fmt} serve"
        bodies = check_quant_serve(tag, model, reqs_in, reqs, st, launches,
                                   fallbacks, bodies, qmm, qmm_bodies,
                                   qmm_fb)
        outputs = [list(r.output_tokens) for r in reqs]
        gen = sum(len(t) for t in outputs)
        kb = st["kv_blocks"]
        row = {"phase": "serve_quant", "model": "llama2_7b",
               "dtype": "bfloat16", "weights": fmt, "kv_format": fmt,
               "requests": len(reqs), "decode_steps": st["steps"],
               "prefill_chunks": st["prefill_chunks"],
               "preemptions": st["preemptions"],
               "cow_forks": kb["cow_forks"],
               "generated_tokens": gen, "seconds": secs,
               "tokens_per_s": gen / secs,
               "kv_bytes_per_token": kb["bytes_per_token"],
               "capacity_vs_bf16": kb["capacity_vs_bf16"],
               "effective_capacity_tokens": kb["effective_capacity_tokens"],
               "model_bytes": model_bytes(model),
               "model_bytes_bf16": bf16_bytes, "convert_seconds": convert_s,
               "peak_memory_gib": peak / 2**30,
               "kernel_launches": launches, "kernel_bodies": bodies,
               "quant_matmul_launches": qmm,
               "quant_matmul_bodies": qmm_bodies, "fallbacks": fallbacks,
               "card": kind}
        del eng
        torch.cuda.empty_cache()
        same = [a == b for a, b in zip(outputs, bf16_outputs)]
        match = [sum(x == y for x, y in zip(a, b))
                 for a, b in zip(outputs, bf16_outputs)]
        row["requests_equal_to_bf16_engine"] = sum(same)
        row["tokens_equal_to_bf16_engine"] = sum(match)
        row.update(_teacher_forced_all(model, [p for p, _ in reqs_in],
                                       outputs, tag, strict=False))
        if fmt == "int8":
            row["generate"] = quant_generate(model, cfg, requests, fmt)
            result = {"serve": launches, "qmm": qmm,
                      "generate": row["generate"]["kernel_launches"]}
        emit(row)
        profile_phase(model, requests, kind, kv_format=fmt)
        if fmt == "int8":
            convert_for_serving(draft, fmt=fmt)
            result["spec"] = spec_lane(
                model, draft, requests, "int8 tree [2,2]",
                dict(spec_tree=(2, 2), kv_format=fmt),
                {"bf16_tokens_per_s": bf16_tps,
                 "outputs": {"bf16": bf16_outputs, "int8": outputs}},
                kind, quant=True)
            del draft
        del model
        torch.cuda.empty_cache()
    return result


def quant_generate(model, cfg, requests, fmt):
    """``generate(kv_format=fmt)`` on two 200-token prompts: K5 serves
    every decode step (the prefill declines for q_len)."""
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.kernels import decode_attention as da

    S, N = 200, 32
    prompts = [p[:S] for p, _ in requests[:2]]
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    generate(model, prompts, max_new_tokens=N, kv_format=fmt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(da.LAUNCHES)
    fallbacks = dict(da.DISPATCH_FALLBACKS)
    expect = cfg.num_hidden_layers * (N - 1)
    k5 = launches["flash_decode_attention_quant"]
    check(k5 == expect, f"{fmt} generate: K5 launched {k5} times, expected "
                        f"{cfg.num_hidden_layers} x {N - 1} = {expect}")
    check(launches["flash_decode_attention"] == 0,
          f"{fmt} generate: the unquantized kernel ran: {launches}")
    check_bodies(f"{fmt} generate", da.BODY_LAUNCHES,
                 {"flash_decode_attention_quant/qrows": expect})
    check(set(fallbacks) <= {"quant_q_len"},
          f"{fmt} generate: fallbacks {fallbacks}")
    return {"B": 2, "prompt_len": S, "new_tokens": N, "seconds": secs,
            "tokens_per_s": 2 * N / secs, "kernel_launches": launches,
            "fallbacks": fallbacks}


def quant_parity_phase(kind):
    """Llama-2-7B's width at depth 2, fp32, int8 weights and int8 KV
    blocks: the same requests through the engine on the card and on the
    CPU (plain versions), from the same converted weights. Checks:
    ``convert_for_serving`` on the card gives the CPU's bits; greedy
    tokens are equal; the card's ``generate(kv_format="int8")`` equals
    the card's engine; the first forward's logits (8 prompt tokens, K9's
    small-M body) agree within 1e-3 over an fp32 cache. Over an int8
    cache (K5) the two devices quantize K/V computed in another
    summation order, so a value near a rounding tie can land one step
    apart: there the count of such values is reported and the logits are
    held to 1e-3 of their largest magnitude, the measure of the JAX
    package's own quantized-logits test."""
    import numpy as np
    import torch

    from paddle_tpu_torch.generation import (generate, make_cached_runner,
                                             make_kv_caches)
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import convert_for_serving
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = seeded_llama(cfg, SEED + 2, "cpu", torch.float32).eval()
    gpu = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32).eval()
    gpu.load_state_dict(cpu.state_dict())
    convert_for_serving(cpu, fmt="int8")
    convert_for_serving(gpu, fmt="int8")
    # conversion on the card against the CPU's: reported; the parity
    # below runs both devices on the CPU's converted weights
    gst, cst = gpu.state_dict(), cpu.state_dict()
    qdiff = sum(int((gst[k].cpu().view(torch.uint8) != cst[k].view(
        torch.uint8)).sum()) for k in cst if k.endswith("qweight")) \
        + sum(int((gst[k].cpu() != cst[k]).sum()) for k in cst
              if k.endswith(".scale"))
    gpu.load_state_dict(cst)
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (40, 200, 90)]
    new = [8, 8, 8]
    outs = {}
    counts = {}
    for name, model, dev in (("cuda", gpu, DEV), ("cpu", cpu, "cpu")):
        scfg = ServingConfig(max_slots=2, max_len=512, block_size=16,
                             prefill_chunk=128, kv_format="int8")
        eng = ServingEngine(model, scfg, device=dev)
        da.reset_counters()
        qm.reset_counters()
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        eng.run_until_idle()
        check(all(r.status == "completed" for r in reqs),
              f"quant_parity: {name} engine left requests unfinished")
        outs[name] = [list(r.output_tokens) for r in reqs]
        counts[name] = {"attention": dict(da.LAUNCHES),
                        "quant_matmul": dict(qm.LAUNCHES)}
        del eng
    gen = [generate(gpu, [p], max_new_tokens=n, kv_format="int8")[0, len(p):]
           .tolist() for p, n in zip(prompts, new)]
    # first forward: 8 prompt tokens over an fp32 and an int8 cache
    ids = prompts[0][:8]
    logits, kv = {}, {}
    for fmt in ("bf16", "int8"):
        for name, model, dev in (("cuda", gpu, DEV), ("cpu", cpu, "cpu")):
            caches = make_kv_caches(cfg, 1, 16, torch.float32, fmt,
                                    device=dev)
            lg, caches = make_cached_runner(model)(
                torch.tensor([ids], device=dev), caches, 0)
            logits[fmt, name] = lg.float().cpu()
            kv[fmt, name] = [c[k].cpu().view(torch.uint8) if fmt == "int8"
                             else None for c in caches for k in ("k", "v")]
    err = {fmt: (logits[fmt, "cuda"] - logits[fmt, "cpu"]).abs().max().item()
           for fmt in ("bf16", "int8")}
    rel = err["int8"] / logits["int8", "cpu"].abs().max().item()
    flips = sum(int((a != b).sum()) for a, b in zip(kv["int8", "cuda"],
                                                   kv["int8", "cpu"]))
    row = {"phase": "quant_parity", "dtype": "float32", "layers": 2,
           "weights": "int8", "kv_format": "int8",
           "requests": len(prompts), "tokens_cuda": outs["cuda"],
           "tokens_cpu": outs["cpu"],
           "tokens_equal": outs["cuda"] == outs["cpu"],
           "generate_equals_engine": gen == outs["cuda"],
           "first_forward_logits_max_abs_err_fp32_kv": err["bf16"],
           "logits_atol": 1e-3,
           "first_forward_logits_max_abs_err_int8_kv": err["int8"],
           "first_forward_logits_err_int8_kv_over_max_logit": rel,
           "logits_rtol_of_max": 1e-3,
           "int8_kv_values_differing_card_vs_cpu": flips,
           "int8_kv_values": sum(t.numel() for t in kv["int8", "cpu"]),
           "qweight_scale_elements_differing_card_vs_cpu_conversion": qdiff,
           "kernel_launches_cuda": counts["cuda"], "card": kind}
    emit(row)
    check(outs["cuda"] == outs["cpu"],
          f"card and CPU int8 engines disagree: {outs}")
    check(gen == outs["cuda"],
          f"card generate(kv_format='int8') != card engine: {gen} vs "
          f"{outs['cuda']}")
    check(qdiff == 0, f"convert_for_serving on the card differs from the "
                      f"CPU's in {qdiff} elements")
    check(err["bf16"] <= 1e-3, f"first-forward logits (fp32 cache) differ "
                               f"by {err['bf16']}")
    check(rel <= 1e-3, f"first-forward logits (int8 cache) differ by "
                       f"{err['int8']}, {rel} of the largest logit")
    check(counts["cuda"]["attention"]["paged_flash_decode_attention_quant"]
          > 0 and counts["cuda"]["quant_matmul"]["quant_matmul"] > 0,
          f"the fp32 card engine did not run K7 and K9: {counts['cuda']}")
    del gpu, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# GPT-3 1.3B: K4-K9 at GPT's shapes, its serving lanes, card against CPU
# ---------------------------------------------------------------------------

# the served GPT model's decode rows: the first eight prompts of TRAFFIC,
# every slot taken (the engine's row lengths at the first decode step)
GPT_ROWS = tuple(n for n, _, _ in TRAFFIC[:8])
# GPT-3 1.3B's (N, K) of q/k/v/out_proj, fc_in, fc_out and lm_head
GPT_QMM_SHAPES = ((2048, 2048), (8192, 2048), (2048, 8192), (50304, 2048))
# the decode kernels at GPT's shapes: (kernel, paged, KV storage, q_len,
# draft tree); q_len 256 is a prefill chunk (B 1, at 1280: the last chunk
# of the 1500-token prompt)
GPT_ATTENTION = (
    ("flash_decode_attention", False, "bf16", 1, None),
    ("flash_decode_attention_quant", False, "int8", 1, None),
    ("paged_flash_decode_attention", True, "bf16", 1, None),
    ("paged_flash_decode_attention", True, "bf16", 256, None),
    ("paged_flash_decode_attention_quant", True, "int8", 1, None),
    ("paged_flash_decode_attention_quant", True, "int8", 256, None),
    ("paged_flash_decode_attention_tree", True, "bf16", 7, (2, 2)),
    ("paged_flash_decode_attention_tree_quant", True, "int8", 7, (2, 2)))
GPT_LANE_TOKENS = 32    # new tokens a request in the sampled and spec runs
GPT_PARAMS = 1_418_842_112          # GPTConfig.gpt3_1p3b()
GPT_KV_BYTES = 196_608              # bf16 K and V a token: 2 x 24 x 2048 x 2
GPT_TF_REQUESTS = 4                 # fp32 full-depth teacher-forced check


def part_timer():
    """(mark, parts): ``mark(name)`` records the seconds since the
    previous mark (or since this call) in ``parts`` under ``name``."""
    parts = {}
    last = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        parts[name] = now - last[0]
        last[0] = now
    return mark, parts


def seeded_gpt(cfg, seed, device, dtype):
    """GPT with linear and embedding weights N(0, 0.02) from a seeded
    generator on ``device``, LayerNorm weights one and every bias zero."""
    import torch

    from paddle_tpu_torch.models import GPTForCausalLM

    model = GPTForCausalLM(cfg, device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln_" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def gpt_attention_rows(rng):
    """K4-K8 against their plain versions at GPT-3 1.3B's shapes (16
    heads of 128, group 1, bf16 queries, B 8 at the engine's row
    lengths, max_len 2048): the decode step over bf16 and int8 storage
    (contiguous K4/K5, paged K6/K7), the 256-token prefill chunk (K6/K7)
    and the [2, 2] verify bundle (K8 over bf16 and int8 pools). SDPA over
    the gathered (dequantized) cache with the same mask is the library
    yardstick."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.generation import spec_tree_plan
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.quantization.intx import unpack_absmax

    dev = torch.device(DEV)
    dtype, dname, isz = torch.bfloat16, "bfloat16", 2
    H, d, max_len, bs = 16, 128, 2048, 16
    nb = max_len // bs
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    rows = []
    for kernel, paged, fmt, w, tree in GPT_ATTENTION:
        quant = fmt != "bf16"
        B = 1 if w == 256 else 8
        pos = np.array([1280]) if w == 256 else np.array(GPT_ROWS)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = torch.randn(B, w, H, d, device=dev, generator=g).to(dtype)

        def store(shape):
            t = torch.randn(shape, device=dev, generator=g)
            return quantize_cache(t, fmt) if quant else (t.to(dtype), None)

        if paged:
            N = B * nb + 1
            (kp, ksc), (vp, vsc) = store((N, bs, H, d)), store((N, bs, H, d))
            bt = torch.tensor((rng.permutation(N - 1)[:B * nb] + 1)
                              .reshape(B, nb).astype("int32"), device=dev)
            kc, vc = da._take_blocks(kp, bt), da._take_blocks(vp, bt)
            kcs, vcs = (None, None) if not quant else (
                da._take_blocks(ksc, bt), da._take_blocks(vsc, bt))
            extra = bt.numel() * 4 + B * 4
        else:
            (kc, kcs), (vc, vcs) = store((B, max_len, H, d)), \
                store((B, max_len, H, d))
            extra = B * 4
        scales = dict(k_scale=ksc if paged else kcs,
                      v_scale=vsc if paged else vcs) if quant else {}
        mask = None
        anc = None
        if tree is not None:
            anc = torch.from_numpy(spec_tree_plan(tree)["anc"])
            mask = anc[None].expand(B, w, w).contiguous().to(dev)
            extra += mask.numel()
        if paged:
            run = lambda: da.paged_flash_decode_attention(  # noqa: E731
                q, kp, vp, bt, pos_t, ancestor_mask=mask, **scales)
            plain = lambda: da.paged_flash_decode_attention_ref(  # noqa: E731
                q, kp, vp, bt, pos_t, ancestor_mask=mask, **scales)
        else:
            run = lambda: da.flash_decode_attention(  # noqa: E731
                q, kc, vc, pos_t, **scales)
            plain = lambda: da.flash_decode_attention_ref(  # noqa: E731
                q, kc, vc, pos_t, **scales)
        got = run()
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lens = [min(int(p) + w, max_len) for p in pos]
        lens_t = torch.tensor(lens, device=dev)
        kd, vd = (unpack_absmax(kc, kcs[..., None], fmt, dtype),
                  unpack_absmax(vc, vcs[..., None], fmt, dtype)) \
            if quant else (kc, vc)
        if tree is None:
            qpos = (lens_t - w)[:, None] + torch.arange(w, device=dev)[None]
            am = (torch.arange(max_len, device=dev)[None, None, :]
                  <= qpos[:, :, None])[:, None]
        else:
            am = da.ancestor_visibility(lens_t - w, mask, max_len)[:, None]
        qs, ks_, vs_ = q.transpose(1, 2), kd.transpose(1, 2), \
            vd.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks_, vs_, attn_mask=am)
        bound, bound_by = attention_bound(
            lens, w, H, H, d, isz, extra, dname,
            kv_itemsize=1 if quant else None, scale_bytes=4 if quant else 0,
            bundle_pairs=int(anc.sum()) if anc is not None else None)
        ms = cuda_ms(run, 50)
        row = {"phase": "gpt_kernel", "model": "gpt3_1p3b", "name": kernel,
               "kv_format": fmt, "dtype": dname,
               "tree": list(tree) if tree else None, "B": B, "q_len": w,
               "heads": H, "kv_heads": H, "group": 1,
               "body": da.bundle_body(w, 1, dtype, fmt), "head_dim": d,
               "max_len": max_len, "block_size": bs if paged else None,
               "pos": [int(p) for p in pos], "max_abs_err": err,
               "atol": ATOL[dname], "ok": err <= ATOL[dname], "ms": ms,
               "bound_share": bound / ms, "plain_ms": cuda_ms(plain, 5),
               "library_ms": cuda_ms(lib, 20),
               "library": "F.scaled_dot_product_attention over the "
                          "gathered" + (" and dequantized" if quant else "")
                          + " cache",
               "bound_ms": bound, "bound_by": bound_by}
        emit(row)
        rows.append(row)
        check(row["ok"], f"{kernel} disagrees with its plain version at "
                         f"GPT's shape: {json.dumps(row)}")
        del kc, vc, kd, vd, ks_, vs_
    torch.cuda.empty_cache()
    return rows


def gpt_kernel_phase():
    """``gpt_kernel``: K4-K8 (``gpt_attention_rows``) and K9 at GPT-3
    1.3B's four linear shapes, M 8 (a decode step of 8 slots) and M 256
    (a prefill chunk), int8 and fp8, bf16 activations: each against its
    plain version with the ``kernel`` rows' tolerances, with its time,
    the plain version's, the library call's and the bound."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    rows = gpt_attention_rows(np.random.RandomState(SEED + 12))
    g = torch.Generator(device=torch.device(DEV)).manual_seed(SEED + 13)
    for fmt in QUANT_FORMATS:
        for N, K in GPT_QMM_SHAPES:
            rows += qmm_rows(N, K, (8, 256), torch.bfloat16, fmt, g,
                             phase="gpt_kernel", model="gpt3_1p3b")
    torch.cuda.empty_cache()
    emit({"phase": "gpt_kernel", "rows": len(rows),
          "phase_seconds": time.perf_counter() - t0})
    return rows


def gpt_serve_phase(kind):
    """``gpt_serve``: ``GPTConfig.gpt3_1p3b(dtype="bfloat16")`` at full
    width and depth with seeded weights (``seeded_gpt``), on the card:
    ``TRAFFIC`` (vocab 50304) through the default-shaped engine (K6
    exactly 24 a decode step and 24 a chunk, by body, no paged fallback),
    ``generate`` on two prompts (K4), a profiled decode iteration, the
    first eight requests (their first ``GPT_LANE_TOKENS`` new tokens)
    sampled (``sample_params``) and through the chain (k 4) and tree
    [2, 2] lanes with ``truncated_draft(target, 2)`` (K6, K8), then the
    same weights converted to int8 (biased weight-only linears) over
    int8 KV blocks: the traffic (K7, K9 exactly, no fallback) and
    ``generate(kv_format="int8")`` (K5). Returns the requests and the
    launch counts by run."""
    import numpy as np
    import torch

    from paddle_tpu_torch.generation import (kv_cache_bytes_per_token,
                                             truncated_draft)
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.quantization import convert_for_serving

    t_phase = time.perf_counter()
    mark, parts = part_timer()
    cfg = GPTConfig.gpt3_1p3b(dtype="bfloat16")
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = seeded_gpt(cfg, SEED + 12, DEV, torch.bfloat16).eval()
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    kv_bytes = kv_cache_bytes_per_token(cfg, "bf16", torch.bfloat16)
    check(params == GPT_PARAMS and kv_bytes == GPT_KV_BYTES,
          f"gpt3_1p3b: {params} parameters, {kv_bytes} KV bytes a token")
    bf16_bytes = model_bytes(model)
    emit({"phase": "gpt_serve", "part": "model", "name": "gpt3_1p3b",
          "dtype": "bfloat16", "params": params, "model_bytes": bf16_bytes,
          "kv_bytes_per_token": kv_bytes,
          "seconds": time.perf_counter() - t0})
    requests = traffic(np.random.RandomState(SEED + 12), cfg.vocab_size)
    out = {}
    mark("model")

    def serve(tag, reqs_in, **kw):
        eng, reqs, secs, launches, fallbacks, bodies = serve_engine(
            model, reqs_in, **kw)
        st = eng.stats()
        del eng
        torch.cuda.empty_cache()
        outputs = [list(r.output_tokens) for r in reqs]
        gen = sum(len(t) for t in outputs)
        return reqs, st, launches, fallbacks, bodies, outputs, {
            "phase": "gpt_serve", "part": tag, "model": "gpt3_1p3b",
            "requests": len(reqs), "decode_steps": st["steps"],
            "prefill_chunks": st["prefill_chunks"],
            "preemptions": st["preemptions"],
            "prompt_tokens": sum(len(p) for p, _ in reqs_in),
            "generated_tokens": gen, "seconds": secs,
            "tokens_per_s": gen / secs, "kernel_launches": launches,
            "fallbacks": fallbacks, "card": kind}

    # bf16 greedy, the whole traffic: K6 24 a decode step and 24 a chunk
    reqs, st, launches, fb, bodies, outputs, row = serve("serve", requests)
    row["kernel_bodies"] = check_serve("gpt bf16", requests, reqs, st,
                                       launches, fb, bodies, L, "bfloat16",
                                       "default")
    row["k6_per_decode_step_and_chunk"] = L
    emit(row)
    out["serve"], tps = launches, row["tokens_per_s"]
    mark("serve")
    out["generate"] = generate_phase(
        model, cfg, requests, kind, False,
        tags={"phase": "gpt_serve", "part": "generate",
              "model": "gpt3_1p3b"})
    mark("generate")
    # the decode iteration only: a profiled prefill window of GPT's many
    # small kernels costs about 20 s of the script's budget
    profile_phase(model, requests, kind, model_name="gpt3_1p3b",
                  windows=(0, 5))
    mark("profile")
    # the first eight requests (their first GPT_LANE_TOKENS new tokens)
    # with the sampled traffic's parameters
    n = SAMPLED_SPEC_REQUESTS
    short = [(p, min(m, GPT_LANE_TOKENS)) for p, m in requests[:n]]
    reqs, st, launches, fb, bodies, sampled, row = serve(
        "sampled", short, params=sample_params(n))
    row["kernel_bodies"] = check_serve("gpt bf16 sampled", short, reqs, st,
                                       launches, fb, bodies, L, "bfloat16",
                                       "default")
    row["tokens"] = sampled
    row["sampled_requests"] = sum(bool(p.get("do_sample"))
                                  for p in sample_params(n))
    emit(row)
    mark("sampled")
    # both speculative lanes on the same eight greedy requests
    draft = truncated_draft(model, DRAFT_LAYERS)
    plain = {"bf16_tokens_per_s": tps, "outputs": {
        "bf16": [o[:m] for o, (_, m) in zip(outputs, short)]}}
    for label, ov in SPEC_LANES[:2]:
        out[label] = spec_lane(model, draft, short, label, ov, plain, kind,
                               model_name="gpt3_1p3b")
        mark(label)
    del draft
    # int8: the same weights converted, biases kept
    t0 = time.perf_counter()
    convert_for_serving(model, fmt="int8")
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    qm.reset_counters()
    reqs, st, launches, fb, bodies, i8, row = serve("int8 serve", requests,
                                                    kv_format="int8")
    qmm = dict(qm.LAUNCHES)
    row["kernel_bodies"] = check_quant_serve(
        "gpt int8 serve", model, requests, reqs, st, launches, fb, bodies,
        qmm, dict(qm.BODY_LAUNCHES), dict(qm.DISPATCH_FALLBACKS))
    kb = st["kv_blocks"]
    row.update({"weights": "int8", "kv_format": "int8",
                "quant_matmul_launches": qmm,
                "quant_matmul_bodies": dict(qm.BODY_LAUNCHES),
                "quant_matmul_per_forward": 6 * L + 1,
                "kv_bytes_per_token": kb["bytes_per_token"],
                "capacity_vs_bf16": kb["capacity_vs_bf16"],
                "model_bytes": model_bytes(model),
                "model_bytes_bf16": bf16_bytes, "convert_seconds": convert_s,
                "bf16_tokens_per_s": tps,
                "requests_equal_to_bf16_engine": sum(
                    a == b for a, b in zip(i8, outputs))})
    row["generate"] = quant_generate(model, cfg, requests, "int8")
    emit(row)
    out["int8 serve"], out["int8 qmm"] = launches, qmm
    out["int8 generate"] = row["generate"]["kernel_launches"]
    del model
    torch.cuda.empty_cache()
    mark("int8")
    emit({"phase": "gpt_serve", "phase_seconds":
          time.perf_counter() - t_phase, "part_seconds": parts})
    return requests, out


def gpt_parity_phase(kind, requests):
    """``gpt_parity``: fp32 GPT-3 1.3B at full width and depth 2, the
    same seeded weights on the card and on the CPU (plain versions).
    Asserts card tokens equal to CPU tokens for the engine, ``generate``,
    the chain (k 4) and tree [2, 2] lanes with a 1-layer draft (drafted
    and accepted counts too), an int8 engine (both from the CPU's
    converted weights) and a sampled engine; then the C1 edge at width
    2048 with ``max_position_embeddings`` 64 = ``EDGE_SERVING``'s
    max_len: card engine = CPU engine = card ``generate``, every logit
    of the card's engine finite (its last chunk's pad rows sit past the
    table). Then fp32 at full depth on the card: the engine's tokens for
    the first ``GPT_TF_REQUESTS`` requests against the card's own
    no-cache forward (teacher-forced, near ties skipped)."""
    import dataclasses

    import numpy as np
    import torch

    from paddle_tpu_torch.generation import generate, truncated_draft
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.quantization import convert_for_serving
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    t_phase = time.perf_counter()
    mark, parts = part_timer()
    cfg = GPTConfig.gpt3_1p3b(num_hidden_layers=2, dtype="float32")

    def empty(c, dev, state):
        """A model of config ``c`` on ``dev`` holding ``state`` (built on
        the meta device: no initializer runs)."""
        m = GPTForCausalLM(c, device="meta", dtype=torch.float32)
        m = m.to_empty(device=dev).eval()
        m.load_state_dict(state)
        return m

    gpu = seeded_gpt(cfg, SEED + 13, DEV, torch.float32).eval()
    cpu = empty(cfg, "cpu", gpu.state_dict())
    mark("models")
    rng = np.random.RandomState(SEED + 13)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (40, 200)]
    new = 6

    def serve(model, dev, draft=None, sampling=None, **ov):
        eng = ServingEngine(model, ServingConfig(
            max_slots=2, max_len=512, block_size=16, prefill_chunk=128,
            **ov), device=dev, draft_model=draft)
        reqs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in
                zip(prompts, sampling or [{}] * len(prompts))]
        eng.run_until_idle()
        check(all(r.status == "completed" for r in reqs),
              f"gpt_parity: {dev} engine left requests unfinished")
        return ([list(r.output_tokens) for r in reqs],
                [(r.spec_drafted, r.spec_accepted) for r in reqs])

    devs = (("cuda", gpu, DEV), ("cpu", cpu, "cpu"))
    res = {}
    res["engine"] = {n: serve(m, d)[0] for n, m, d in devs}
    mark("engine")
    res["generate"] = {n: [generate(m, [p], max_new_tokens=new)[0, len(p):]
                           .tolist() for p in prompts] for n, m, d in devs}
    mark("generate")
    drafts = {n: truncated_draft(m, 1) for n, m, _ in devs}
    for label, ov in (("chain k4", dict(spec_k=4)),
                      ("tree [2,2]", dict(spec_tree=(2, 2)))):
        res[label] = {n: serve(m, d, drafts[n], **ov) for n, m, d in devs}
        check(res[label]["cuda"][0] == res["engine"]["cuda"],
              f"gpt_parity {label}: card spec tokens differ from the card's "
              f"plain engine")
        mark(label)
    sp = [dict(SAMPLE_CYCLE[1 + i], seed=100 + i)
          for i in range(len(prompts))]
    res["sampled engine"] = {n: serve(m, d, sampling=sp)[0]
                             for n, m, d in devs}
    mark("sampled engine")
    del drafts
    # the C1 edge: max_len == max_position_embeddings, the last chunk's
    # pads past the learned table; the same weights, wpe cut to its rows
    ecfg = dataclasses.replace(cfg, max_position_embeddings=EDGE_SERVING[
        "max_len"])
    est = dict(cpu.state_dict())
    est["gpt.wpe.weight"] = est["gpt.wpe.weight"][:EDGE_SERVING["max_len"]]
    ecpu, egpu = empty(ecfg, "cpu", est), empty(ecfg, DEV, est)
    prompt = np.random.RandomState(3).randint(1, ecfg.vocab_size,
                                              56).tolist()
    finite = []
    hook = egpu.lm_head.register_forward_hook(
        lambda mod, inp, o: finite.append(bool(torch.isfinite(o).all())))
    edge = {}
    for name, model, dev in (("cuda", egpu, DEV), ("cpu", ecpu, "cpu")):
        eng = ServingEngine(model, ServingConfig(**EDGE_SERVING), device=dev)
        req = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_idle()
        check(req.status == "completed",
              f"gpt_parity edge: the {name} engine left the request "
              f"unfinished")
        edge[name] = list(req.output_tokens)
        if name == "cuda":
            hook.remove()
    edge["generate cuda"] = generate(egpu, [prompt],
                                     max_new_tokens=6)[0, 56:].tolist()
    res["edge"] = edge
    del egpu, ecpu, est
    mark("edge")
    convert_for_serving(cpu, fmt="int8")
    convert_for_serving(gpu, fmt="int8")
    gpu.load_state_dict(cpu.state_dict())
    res["int8 engine"] = {n: serve(m, d, kv_format="int8")[0]
                          for n, m, d in devs}
    del gpu, cpu
    torch.cuda.empty_cache()
    mark("int8 engine")
    row = {"phase": "gpt_parity", "dtype": "float32", "layers": 2,
           "model": "gpt3_1p3b", "requests": len(prompts), "new_tokens": new,
           **{k: v for k, v in res.items()},
           "edge_forwards_all_finite": finite, "card": kind}
    for label in ("engine", "generate", "sampled engine", "int8 engine",
                  "chain k4", "tree [2,2]"):
        row[f"{label} card == cpu"] = res[label]["cuda"] == res[label]["cpu"]
    emit(row)
    for label in ("engine", "generate", "sampled engine", "int8 engine",
                  "chain k4", "tree [2,2]"):
        check(res[label]["cuda"] == res[label]["cpu"],
              f"gpt_parity {label}: card {res[label]['cuda']} != CPU "
              f"{res[label]['cpu']}")
    check(res["generate"]["cuda"] == res["engine"]["cuda"],
          "gpt_parity: card generate differs from the card engine")
    check(edge["cuda"] == edge["cpu"] == edge["generate cuda"],
          f"gpt_parity edge: {edge}")
    check(finite and all(finite),
          f"gpt_parity edge: non-finite logits on the card {finite}")
    # fp32 at full depth: the engine against the card's no-cache forward
    t0 = time.perf_counter()
    fcfg = GPTConfig.gpt3_1p3b(dtype="float32")
    model = seeded_gpt(fcfg, SEED + 12, DEV, torch.float32).eval()
    reqs_in = requests[:GPT_TF_REQUESTS]
    eng, reqs, secs, launches, fb, bodies = serve_engine(model, reqs_in)
    st = eng.stats()
    del eng
    bodies = check_serve("gpt fp32", reqs_in, reqs, st, launches, fb,
                         bodies, fcfg.num_hidden_layers, "float32",
                         "default")
    tf = _teacher_forced_all(model, [p for p, _ in reqs_in],
                             [list(r.output_tokens) for r in reqs],
                             "gpt fp32 full depth", strict=True)
    emit({"phase": "gpt_parity", "part": "teacher_forced",
          "dtype": "float32", "layers": fcfg.num_hidden_layers,
          "requests": len(reqs_in), "kernel_bodies": bodies, **tf,
          "seconds": time.perf_counter() - t0, "card": kind})
    del model
    torch.cuda.empty_cache()
    mark("teacher_forced")
    emit({"phase": "gpt_parity", "phase_seconds":
          time.perf_counter() - t_phase, "part_seconds": parts})


# ---------------------------------------------------------------------------
# ResNet-50: K10 (inference) and K11 (the train step)
# ---------------------------------------------------------------------------

CONV_META = {
    "fused_conv_bn_eval": (
        "K10", "paddle_tpu/pallas_kernels/fused_conv.py:199 "
               "(_pallas_epilogue, _epilogue_kernel :158)"),
    "fused_conv_bn_eval_relu": (
        "K10", "paddle_tpu/pallas_kernels/fused_conv.py:199 "
               "(_pallas_epilogue with relu, _epilogue_kernel :158)"),
    "conv_stats": (
        "K11", "paddle_tpu/pallas_kernels/fused_conv.py:255 "
               "(_pallas_stats, _stats_kernel :168)"),
    "conv_stats_pre": (
        "K11", "paddle_tpu/pallas_kernels/fused_conv.py:255 "
               "(_pallas_stats with the pre prologue, _stats_kernel :168, "
               "_conv_acc :108-126)"),
}
RESNET_BATCH, RESNET_RES = 256, 224
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
RESNET_PARITY_BATCH, RESNET_PARITY_RES, RESNET_PARITY_LR = 8, 128, 1e-6
RESNET_WARMUP, RESNET_STEPS, RESNET_INFER_BATCHES = 3, 10, 10
# ResNet-50's 46 qualifying conv units at 224 x 224, as 16 distinct
# (H = W, C, K, kernel) with the units of each, whether the eval unit has
# its ReLU in the epilogue, and the K11 variants the train step launches
# at that shape (plain conv_stats: every conv1, layer1's downsample, the
# conv3 after a stride-2 conv2; conv_stats_pre: the stride-1 conv2s and
# the conv3s after them)
RESNET50_CONVS = [
    (56, 64, 64, 1, 1, True, {"conv_stats": 1}),
    (56, 256, 64, 1, 2, True, {"conv_stats": 2}),
    (56, 64, 64, 3, 3, True, {"conv_stats_pre": 3}),
    (56, 64, 256, 1, 4, False, {"conv_stats": 1, "conv_stats_pre": 3}),
    (56, 256, 128, 1, 1, True, {"conv_stats": 1}),
    (28, 128, 512, 1, 4, False, {"conv_stats": 1, "conv_stats_pre": 3}),
    (28, 512, 128, 1, 3, True, {"conv_stats": 3}),
    (28, 128, 128, 3, 3, True, {"conv_stats_pre": 3}),
    (28, 512, 256, 1, 1, True, {"conv_stats": 1}),
    (14, 256, 1024, 1, 6, False, {"conv_stats": 1, "conv_stats_pre": 5}),
    (14, 1024, 256, 1, 5, True, {"conv_stats": 5}),
    (14, 256, 256, 3, 5, True, {"conv_stats_pre": 5}),
    (14, 1024, 512, 1, 1, True, {"conv_stats": 1}),
    (7, 512, 2048, 1, 3, False, {"conv_stats": 1, "conv_stats_pre": 2}),
    (7, 2048, 512, 1, 2, True, {"conv_stats": 2}),
    (7, 512, 512, 3, 2, True, {"conv_stats_pre": 2}),
]
# per forward (eval) and per step (train), from the table above
K10_PER_FORWARD = {
    "fused_conv_bn_eval_relu": sum(u for *_, u, r, _t in RESNET50_CONVS if r),
    "fused_conv_bn_eval": sum(u for *_, u, r, _t in RESNET50_CONVS if not r)}
K11_PER_STEP = {v: sum(t.get(v, 0) for *_, t in RESNET50_CONVS)
                for v in ("conv_stats", "conv_stats_pre")}
# small and odd shapes (case, N, H, W, C, K, kernel, dtype): the JAX
# package's tests/test_fused_conv.py shapes, odd channel counts (the
# plain-FMA body in bf16), a partial 32-channel step with a ragged K, and
# a 1x1 image under a 3x3 kernel (where the TPU kernel cannot slice)
CONV_EXTRA = [
    ("jax_test_3x3", 2, 8, 8, 16, 32, 3),
    ("jax_test_odd_n", 3, 6, 5, 8, 8, 3),
    ("jax_test_1x1", 2, 7, 7, 32, 16, 1),
    ("jax_test_small", 1, 4, 4, 8, 8, 1),
    ("odd_c", 2, 4, 4, 6, 8, 3),
    ("ragged", 4, 9, 7, 24, 40, 3),
    ("odd_k", 3, 5, 5, 16, 13, 1),
    ("image_1x1", 8, 1, 1, 64, 64, 3),
]
# bf16 outputs: atol plus one rounding step of the stored value (2^-7 of
# it): kernel and plain version round the same f32 sum, summed in another
# order, so a value near a rounding boundary may land one step apart
CONV_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
STATS_TOL = 1e-4    # batch mean and variance: atol and rtol (f32 sums)


def conv_bound(M, C, K, ks, isz, dname, extra_bytes):
    """Least time for one fused conv: x, w and the output moved once (plus
    the small per-channel vectors), or 2*M*K*C*taps operations at the
    dtype's peak, whichever is larger."""
    nbytes = (M * C + K * C * ks * ks + M * K) * isz + extra_bytes
    t_bytes = nbytes / PEAKS["bw"] * 1e3
    t_ops = 2 * M * K * C * ks * ks / PEAKS[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _close(got, want, dname):
    """(max |got - want|, every element within atol + rtol * |want|)."""
    d = (got.float() - want.float()).abs()
    lim = ATOL[dname] + CONV_RTOL[dname] * want.float().abs()
    return d.max().item(), bool((d <= lim).all())


def conv_row(variant, case, n, h, w, c, k, ks, dtype, g, units=None):
    """One kernel variant against its plain version on seeded inputs,
    timed beside the plain version and the cuDNN conv of the same x and w
    (the library yardstick), with its TFLOP/s, its share of the bound and
    the launch plan's body, mode and tile width; ``units``: the row's
    launches a pass on the ResNet-50 path."""
    import math

    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import fused_conv as fc

    dev = torch.device(DEV)
    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    x = torch.randn(n, h, w, c, device=dev, generator=g).to(dtype)
    bound_w = math.sqrt(6.0 / (c * ks * ks))   # KaimingUniform
    wt = ((torch.rand(k, c, ks, ks, device=dev, generator=g) * 2 - 1)
          * bound_w).to(dtype)
    extra = 0
    if variant.startswith("fused_conv_bn_eval"):
        relu = variant.endswith("relu")
        scale = torch.rand(k, device=dev, generator=g) + 0.5
        shift = torch.randn(k, device=dev, generator=g) * 0.1
        run = lambda: fc.fused_conv_bn_eval(x, wt, scale, shift, relu)  # noqa
        plain = lambda: (fc._eval_ref(x, wt, scale, shift, relu),)  # noqa
        extra = 2 * k * 4
    elif variant == "conv_stats":
        run = lambda: fc.conv_stats(x, wt)  # noqa
        plain = lambda: fc._conv_stats_ref(x, wt)  # noqa
        extra = 2 * k * 4
    else:
        m_p = torch.randn(c, device=dev, generator=g) * 0.1
        v_p = torch.rand(c, device=dev, generator=g) * 1.5 + 0.5
        gp = (torch.rand(c, device=dev, generator=g) + 0.5).to(dtype)
        bp = (torch.randn(c, device=dev, generator=g) * 0.1).to(dtype)
        run = lambda: fc.conv_stats_pre(x, m_p, v_p, gp, bp, wt)  # noqa
        plain = lambda: fc._conv_stats_pre_ref(  # noqa
            x, m_p, v_p, gp, bp, wt, True, 1e-5)
        extra = 2 * k * 4 + 2 * c * (4 + isz)
    lib = lambda: TF.conv2d(x.permute(0, 3, 1, 2), wt,  # noqa
                            padding=(ks - 1) // 2)
    plan = fc.conv_plan(n, h, w, c, k, ks, dtype == torch.bfloat16)
    with torch.no_grad():
        got = run()
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        torch.cuda.synchronize()
        err, ok = _close(got[0], want[0], dname)
        stats_err = None
        if len(got) == 3:
            stats_err = max((a - b).abs().max().item()
                            for a, b in zip(got[1:], want[1:]))
            ok = ok and all(bool(((a - b).abs() <= STATS_TOL * (1 + b.abs()))
                                 .all()) for a, b in zip(got[1:], want[1:]))
        M = n * h * w
        bound, bound_by = conv_bound(M, c, k, ks, isz, dname, extra)
        ms = cuda_ms(run, 20)
        row = {"phase": "conv_kernel", "name": variant, "case": case,
               "dtype": dname, "N": n, "H": h, "W": w, "C": c, "K": k,
               "kernel": ks, "body": plan.body, "mode": plan.mode,
               "tn": plan.tn, "max_abs_err": err, "atol": ATOL[dname],
               "rtol": CONV_RTOL[dname], "stats_max_abs_err": stats_err,
               "ok": ok, "bound_ms": bound, "bound_by": bound_by,
               "library": "cuDNN F.conv2d, channels_last", "ms": ms,
               "tflops": 2 * M * k * c * ks * ks / ms / 1e9,
               "bound_share": bound / ms, "plain_ms": cuda_ms(plain, 3),
               "library_ms": cuda_ms(lib, 20)}
        if units is not None:
            row["units"] = units
    emit(row)
    check(ok, f"{variant} disagrees with its plain version: "
              f"{json.dumps(row)}")
    return row


def conv_kernel_phase():
    """K10 (with and without its ReLU) and K11 (plain and with the
    prologue) at ResNet-50's 16 batch-256 shapes in bf16, each variant the
    path runs there; then the small, odd and 1x1-image cases in bf16 and
    fp32. Returns the rows."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(SEED + 10)
    check(K10_PER_FORWARD == {"fused_conv_bn_eval_relu": 29,
                              "fused_conv_bn_eval": 17}
          and K11_PER_STEP == {"conv_stats": 20, "conv_stats_pre": 26},
          f"ResNet-50 table: {K10_PER_FORWARD} {K11_PER_STEP}")
    rows = []
    for h, c, k, ks, units, relu, train in RESNET50_CONVS:
        case = f"resnet50 {h}x{h} {c}->{k} k{ks}"
        k10 = "fused_conv_bn_eval_relu" if relu else "fused_conv_bn_eval"
        for variant, count in ((k10, units),) + tuple(train.items()):
            rows.append(conv_row(variant, case, RESNET_BATCH, h, h, c, k,
                                 ks, torch.bfloat16, g, units=count))
        torch.cuda.empty_cache()
    for case, n, h, w, c, k, ks in CONV_EXTRA:
        for dtype in (torch.bfloat16, torch.float32):
            for variant in CONV_META:
                rows.append(conv_row(variant, case, n, h, w, c, k, ks, dtype,
                                     g))
    torch.cuda.empty_cache()
    return rows


def resnet50_model(dtype, device, seed):
    """resnet50(num_classes=1000) from the port's initializers under
    ``torch.manual_seed(seed)`` on the CPU (so the card and the CPU get
    the same weights), moved to ``device``, cast, channels-last, with the
    space-to-depth stem (bench.py's preparation)."""
    import torch

    from paddle_tpu_torch.nn import space_to_depth_stem, to_channels_last
    from paddle_tpu_torch.vision.models import resnet50

    torch.manual_seed(seed)
    model = resnet50(num_classes=1000, device="cpu").to(device=device,
                                                        dtype=dtype)
    to_channels_last(model)
    space_to_depth_stem(model)
    return model


def resnet50_flops(batch, res):
    """Forward operations of ResNet-50 (2 per multiply-add): every conv at
    its output size (the stem as the 7x7 it stands for) and the fc."""
    total = 2 * (res // 2) ** 2 * 64 * 3 * 49           # stem
    h, cin = res // 4, 64
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                                   (512, 3, 2)):
        for b in range(blocks):
            s = stride if b == 0 else 1
            ho = h // s
            total += 2 * h * h * cin * planes                 # conv1
            total += 2 * ho * ho * planes * planes * 9        # conv2
            total += 2 * ho * ho * planes * planes * 4        # conv3
            if b == 0:
                total += 2 * ho * ho * cin * planes * 4       # downsample
            h, cin = ho, planes * 4
    return batch * (total + 2 * 2048 * 1000)


class _Conv2dCounter:
    """Counts calls of the port's ``nn.functional.conv2d`` (the cuDNN
    route every non-qualifying conv takes) while installed."""

    def __init__(self):
        from paddle_tpu_torch.nn import functional as PF

        self.mod, self.orig, self.calls = PF, PF.conv2d, 0

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)

        self.mod.conv2d = counted
        return self

    def __exit__(self, *exc):
        self.mod.conv2d = self.orig


def resnet_batch(n, res, classes, dtype, seed, device):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, 3, res, res).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, classes, (n,)).astype(np.int64))
    return x.to(device=device, dtype=dtype), y.to(device)


def resnet_infer_phase(kind):
    """ResNet-50 inference, bf16, batch 256 at 224 x 224: warm-up, then
    timed batches under no_grad; asserts 46 K10 launches per forward (29
    with the ReLU, 17 without), no fallback, and cuDNN only for the 7
    non-qualifying convs. Returns the launches of the timed batches."""
    import math

    import torch

    from paddle_tpu_torch.kernels import fused_conv as fc
    from paddle_tpu_torch.nn import layers_conv_norm as lcn

    model = resnet50_model(torch.bfloat16, DEV, SEED).eval()
    x, _ = resnet_batch(RESNET_BATCH, RESNET_RES, 1000, torch.bfloat16,
                        SEED, DEV)
    with torch.no_grad():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_counters()
        lcn.reset_dispatch_counter()
        n = RESNET_INFER_BATCHES
        with _Conv2dCounter() as convs:
            t0 = time.perf_counter()
            for _ in range(n):
                logits = model(x)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = dict(fc.LAUNCHES)
        dispatch = {"/".join(k): v for k, v in lcn.FUSED_CONV_DISPATCH.items()}
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        prof = device_window(lambda: model(x), 1)
    row = {"phase": "resnet_infer", "model": "resnet50", "dtype": "bfloat16",
           "batch": RESNET_BATCH, "resolution": RESNET_RES, "batches": n,
           "ms_per_batch": secs / n * 1e3,
           "images_per_s": RESNET_BATCH * n / secs,
           "peak_memory_gib": peak / 2**30,
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "kernel_launches": launches, "dispatch": dispatch,
           "cudnn_convs_per_forward": convs.calls / n, "card": kind}
    emit(row)
    emit({"phase": "profile", "model": "resnet50", "dtype": "bfloat16",
          "what": "one eval batch of 256", "eval_batch": prof, "card": kind})
    check(finite and list(logits.shape) == [RESNET_BATCH, 1000],
          f"bad logits: {row}")
    want = {k: v * n for k, v in K10_PER_FORWARD.items()}
    want.update(conv_stats=0, conv_stats_pre=0)
    check(launches == want, f"K10 launches {launches}, expected {want}")
    check(dispatch == {"hit/eval": 46 * n, "fallback/ineligible": 6 * n},
          f"fused-conv dispatch {dispatch}")
    check(convs.calls == 7 * n, f"{convs.calls / n} cuDNN convs a forward, "
                                f"expected the 7 that do not qualify")
    check(math.isfinite(row["images_per_s"]), "no time")
    del model, x, logits
    torch.cuda.empty_cache()
    return launches


def resnet_train_phase(kind):
    """bench.py's ResNet-50 train step: bf16 parameters and batch (256 x
    224 x 224), Momentum(0.1, 0.9, wd 1e-4), cross entropy, one repeated
    seeded batch; warm-up and timed steps, then a profiled step. Asserts
    finite losses, a first loss within 0.5 of ln(1000), a falling loss and
    46 K11 launches a step (20 plain, 26 with the prologue). Returns the
    launches of the warm-up and timed steps."""
    import math

    import torch

    from paddle_tpu_torch.distributed import ShardedTrainStep
    from paddle_tpu_torch.kernels import fused_conv as fc
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.nn import layers_conv_norm as lcn
    from paddle_tpu_torch.optimizer import Momentum

    model = resnet50_model(torch.bfloat16, DEV, SEED)
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   weight_decay=RESNET_WD)
    step = ShardedTrainStep(
        model, lambda lo, la: PF.cross_entropy(lo, la).mean(), opt)
    x, y = resnet_batch(RESNET_BATCH, RESNET_RES, 1000, torch.bfloat16,
                        SEED, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_counters()
    lcn.reset_dispatch_counter()
    losses = [step.step(x, y).item() for _ in range(RESNET_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step.step(x, y) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses += [t.item() for t in timed]
    launches = dict(fc.LAUNCHES)
    dispatch = {"/".join(k): v for k, v in lcn.FUSED_CONV_DISPATCH.items()}
    peak = torch.cuda.max_memory_allocated()
    n_steps = RESNET_WARMUP + RESNET_STEPS
    ips = RESNET_BATCH * RESNET_STEPS / secs
    flops = 3 * resnet50_flops(RESNET_BATCH, RESNET_RES)
    row = {"phase": "resnet_train", "model": "resnet50 (bench.py "
           "_run_resnet50)", "dtype": "bfloat16", "batch": RESNET_BATCH,
           "resolution": RESNET_RES, "optimizer": "Momentum(0.1, 0.9, "
           "weight_decay=1e-4)", "warmup_steps": RESNET_WARMUP,
           "timed_steps": RESNET_STEPS, "losses": losses,
           "ms_per_step": secs / RESNET_STEPS * 1e3, "images_per_s": ips,
           "peak_memory_gib": peak / 2**30,
           "step_tflop": flops / 1e12,
           "mfu_estimate": ips / RESNET_BATCH * flops / PEAKS["bfloat16"],
           "mfu_note": "estimate: 3 x the forward's conv and fc operations "
                       "against the 989 TFLOP/s bf16 data-sheet peak",
           "kernel_launches": launches, "dispatch": dispatch, "card": kind}
    emit(row)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - math.log(1000)) < 0.5,
          f"first loss {losses[0]} not within 0.5 of ln(1000)")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {k: v * n_steps for k, v in K11_PER_STEP.items()}
    want.update(fused_conv_bn_eval=0, fused_conv_bn_eval_relu=0)
    check(launches == want, f"K11 launches {launches}, expected {want}")
    check(dispatch == {"hit/train": 46 * n_steps,
                       "fallback/ineligible": 6 * n_steps},
          f"fused-conv dispatch {dispatch}")
    prof = device_window(lambda: step.step(x, y), 1)
    emit({"phase": "profile", "model": "resnet50", "dtype": "bfloat16",
          "what": "one train step (forward, loss, backward, Momentum)",
          "train_step": prof, "card": kind})
    del step, model, x, y
    torch.cuda.empty_cache()
    return launches


def _resnet_grads(model, x, y):
    """(loss, {name: gradient}) of one train-mode forward and backward."""
    import torch

    from paddle_tpu_torch.nn import functional as PF

    model.train()
    loss = PF.cross_entropy(model(x), y)
    names, params = zip(*model.named_parameters())
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))


def _leaf_errors(grads, oracle):
    """Each parameter's gradient distance from the fp64 one, relative to
    the fp64 gradient's own norm."""
    return {k: (grads[k] - g).norm().item() / max(g.norm().item(), 1e-30)
            for k, g in oracle.items()}


def resnet_parity_phase(kind):
    """ResNet-50 in fp32 at 8 x 3 x 128 x 128, the same weights on the
    card (through K10/K11) and the CPU (plain versions).

    - Eval logits within 1e-4 of the largest logit.
    - One train-mode forward and backward: losses to rtol 1e-4; each
      parameter's gradient against an fp64 CPU run (the unfused
      composition), relative to its own norm, no further off on the card
      than twice the CPU fp32 run's worst leaf, and the median leaf no
      further than twice the CPU's median. fp32 gradients of a randomly
      initialised ResNet-50 are themselves 1-3% of each leaf's norm off
      fp64: ReLU and max-pool masks flip between two fp32 runs, and each
      flipped position is one of the few hundred a BatchNorm averages;
      two fp32 runs cannot be held closer than that.
    - Three Momentum steps at lr 1e-6 (momentum 0.9, weight decay 1e-4):
      every loss to rtol 1e-4 and every weight within lr. The loss falls
      about 1.4% over the three steps; a larger lr amplifies the
      gradients' fp32 noise past the bound even between two CPU runs."""
    import math
    import statistics

    import torch

    from paddle_tpu_torch.distributed import ShardedTrainStep
    from paddle_tpu_torch.kernels import fused_conv as fc
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.optimizer import Momentum

    n, res, lr = RESNET_PARITY_BATCH, RESNET_PARITY_RES, RESNET_PARITY_LR
    x, y = resnet_batch(n, res, 1000, torch.float32, SEED + 2, "cpu")
    models = {d: resnet50_model(torch.float32, d, SEED + 2).eval()
              for d in (DEV, "cpu")}
    fc.reset_counters()
    with torch.no_grad():
        logits = {d: m(x.to(d)).cpu() for d, m in models.items()}
    eval_launches = dict(fc.LAUNCHES)
    scale = max(1.0, logits["cpu"].abs().max().item())
    l_err = (logits[DEV] - logits["cpu"]).abs().max().item()

    fc.reset_counters()
    grads, first = {}, {}
    for d, m in models.items():
        first[d], g = _resnet_grads(m, x.to(d), y.to(d))
        grads[d] = {k: v.cpu().double() for k, v in g.items()}
    grad_launches = dict(fc.LAUNCHES)
    oracle = resnet50_model(torch.float64, "cpu", SEED + 2)
    first["cpu_fp64"], g64 = _resnet_grads(oracle, x.double(), y)
    del oracle
    leaf = {d: _leaf_errors(grads[d], g64) for d in grads}
    g_worst = {d: max((e, k) for k, e in leaf[d].items()) for d in leaf}
    g_median = {d: statistics.median(leaf[d].values()) for d in leaf}
    g_rel = abs(first[DEV] - first["cpu"]) / abs(first["cpu"])

    losses, steps = {}, {}
    fc.reset_counters()
    for d, m in models.items():
        steps[d] = ShardedTrainStep(
            m, lambda lo, la: PF.cross_entropy(lo, la).mean(),
            Momentum(learning_rate=lr, momentum=RESNET_MOMENTUM,
                     weight_decay=RESNET_WD))
        losses[d] = [steps[d].step(x.to(d), y.to(d)).item()
                     for _ in range(3)]
    train_launches = dict(fc.LAUNCHES)
    w_err, worst = max(
        ((steps[DEV].params[k].cpu() - p).abs().max().item(), k)
        for k, p in steps["cpu"].params.items())
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[DEV],
                                                   losses["cpu"]))
    row = {"phase": "resnet_parity", "dtype": "float32",
           "input": [n, 3, res, res], "logits_max_abs_err": l_err,
           "logits_scale": scale, "logits_tol": 1e-4 * scale,
           "grad_step_losses": first, "grad_step_loss_rel_err": g_rel,
           "grad_leaf_rel_err_worst_vs_fp64": g_worst,
           "grad_leaf_rel_err_median_vs_fp64": g_median,
           "lr": lr, "losses": losses, "loss_max_rel_err": rel,
           "loss_rtol": 1e-4, "weight_max_abs_err_after_3": w_err,
           "weight_worst": worst, "weight_atol": lr,
           "eval_launches_cuda": eval_launches,
           "grad_launches_cuda": grad_launches,
           "train_launches_cuda": train_launches, "card": kind}
    emit(row)
    check(l_err <= 1e-4 * scale, f"card and CPU logits differ: {l_err}")
    check(g_rel <= 1e-4 and rel <= 1e-4,
          f"card and CPU losses differ: {first}, {losses}")
    check(g_worst[DEV][0] <= 2 * g_worst["cpu"][0]
          and g_median[DEV] <= 2 * g_median["cpu"],
          f"card gradients further from fp64 than the CPU's: {g_worst}, "
          f"{g_median}")
    check(all(math.isfinite(v) for v in losses[DEV]),
          f"non-finite card losses {losses}")
    check(w_err <= lr, f"card and CPU weights differ after 3 steps: "
                       f"{w_err} ({worst})")
    check(sum(eval_launches.values()) == 46
          and sum(grad_launches.values()) == 46
          and sum(train_launches.values()) == 3 * 46,
          f"fp32 card run did not take the kernels: {eval_launches}, "
          f"{grad_launches}, {train_launches}")
    del models, steps
    torch.cuda.empty_cache()


def conv_summary(conv_rows, infer_launches, resnet_train_launches):
    """One object per K10/K11 variant: its row at the ResNet-50 shape
    where it has the most work (units x bound), and its ms, plain ms,
    library ms and bound summed over the units of one forward (K10) or
    one train step's forward (K11) as ``per_pass``; emits those sums of
    K10 a forward and K11 a step beside cuDNN's and the bound."""
    out = []
    passes = {}
    for tag, what in (("K10", "forward"), ("K11", "step")):
        path = [r for r in conv_rows if "units" in r
                and CONV_META[r["name"]][0] == tag]
        passes[f"{tag}_{what}"] = {
            k: sum(r["units"] * r[k] for r in path)
            for k in ("ms", "library_ms", "bound_ms", "plain_ms")}
        passes[f"{tag}_{what}"]["launches"] = sum(r["units"] for r in path)
    emit({"phase": "conv_summary", **passes})
    for name, (tag, replaces) in CONV_META.items():
        mine = [r for r in conv_rows if r["name"] == name]
        path = [r for r in mine if "units" in r]
        main = max(path, key=lambda r: r["units"] * r["bound_ms"])
        launches = (infer_launches if tag == "K10"
                    else resnet_train_launches)[name]
        out.append({"name": name, "route": "cuda",
                    "source": "paddle_tpu_torch/kernels/csrc/fused_conv.cu",
                    "replaces": replaces, "tpu_counterpart": tag,
                    "launches": launches,
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"], "main_case": main["case"],
                    "per_pass": {k: sum(r["units"] * r[k] for r in path)
                                 for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms")},
                    "ok": all(r["ok"] for r in mine)})
    return out


def summary(rows, serve_launches, gen_launches, flash_rows,
            train_launches, quant_rows, quant_launches, tree_rows,
            spec_launches, gpt_rows, gpt_launches, http_launches,
            router_launches):
    """One object per kernel, with the numbers of its main-path shape:
    for K1-K3 the training shape, for K4-K7 the decode step (bf16, group
    1 as in Llama-2-7B; int8 for K5/K7), for K8 the [2, 2] tree's verify
    bundle (q_len 7, bf16; int8 pools for its quantized variant; launches
    from the tree [2,2] lanes), for K9 q_proj's weight in int8
    at a decode step of 8 slots. The decode kernels and K9 add
    ``gpt_launches`` (the GPT path's runs) and ``gpt``: the row at GPT-3
    1.3B's shape (K9: q_proj, 2048 x 2048, int8, M 8). K6 adds
    ``http_launches``: its launches over the HTTP front end's run, and
    ``router_launches``: over the two supervised replicas' router run."""
    out = []
    for name, (tag, replaces) in FLASH_META.items():
        mine = [r for r in flash_rows if r["name"] == name]
        main = next(r for r in mine if r["case"] == "main")
        out.append({"name": name, "route": "cuda",
                    "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                    "replaces": replaces, "tpu_counterpart": tag,
                    "launches": train_launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    **({"body": main["body"]} if main["body"] else {}),
                    "ok": all(r["ok"] for r in mine)})
    meta = {
        "flash_decode_attention": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:491 "
                        "(_flash_decode, _decode_kernel :336)",
            "tpu_counterpart": "K4", "launches": gen_launches,
            "gpt_launches": gpt_launches["generate"],
            "main": dict(dtype="bfloat16", q_len=1, group=1)},
        "paged_flash_decode_attention": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:685 "
                        "(_paged_flash_decode, _decode_kernel :336)",
            "tpu_counterpart": "K6", "launches": serve_launches,
            "gpt_launches": gpt_launches["serve"],
            "main": dict(dtype="bfloat16", q_len=1, group=1),
            "bundle": dict(dtype="bfloat16", q_len=256, group=1)},
        "flash_decode_attention_quant": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:491 "
                        "(_flash_decode quant, _decode_kernel_quant :371)",
            "tpu_counterpart": "K5", "launches": quant_launches["generate"],
            "gpt_launches": gpt_launches["int8 generate"],
            "main": dict(dtype="bfloat16", kv_format="int8", q_len=1,
                         group=1)},
        "paged_flash_decode_attention_quant": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:685 "
                        "(_paged_flash_decode quant, _decode_kernel_quant "
                        ":371)",
            "tpu_counterpart": "K7", "launches": quant_launches["serve"],
            "gpt_launches": gpt_launches["int8 serve"],
            "main": dict(dtype="bfloat16", kv_format="int8", q_len=1,
                         group=1),
            "bundle": dict(dtype="bfloat16", kv_format="int8", q_len=256,
                           group=1)},
        "paged_flash_decode_attention_tree": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:685 "
                        "(_paged_flash_decode with ancestor_mask, "
                        "_cell_partial mask branch :299-316)",
            "tpu_counterpart": "K8", "launches": spec_launches["tree [2,2]"],
            "gpt_launches": gpt_launches["tree [2,2]"],
            "main": dict(dtype="bfloat16", pool="bf16", q_len=7, group=1),
            "bundle": dict(dtype="bfloat16", pool="bf16", q_len=29,
                           group=1)},
        "paged_flash_decode_attention_tree_quant": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:685 "
                        "(_paged_flash_decode quant with ancestor_mask, "
                        "_decode_kernel_quant :371 -> _cell_partial mask "
                        "branch :299-316)",
            "tpu_counterpart": "K8", "launches": quant_launches["spec"],
            "gpt_launches": {},       # no GPT lane runs K8 over int8 pools
            "main": dict(dtype="bfloat16", pool="int8", q_len=7, group=1),
            "bundle": dict(dtype="bfloat16", pool="int8", q_len=29,
                           group=1)},
        "quant_matmul": {
            "replaces": "paddle_tpu/pallas_kernels/quant_matmul.py:193 "
                        "(quant_matmul, _qmm_kernel :126)",
            "tpu_counterpart": "K9", "launches": quant_launches["qmm"],
            "gpt_launches": gpt_launches["int8 qmm"],
            "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
            "main": dict(dtype="bfloat16", weight_format="int8", M=8,
                         N=4096, K=4096),
            "prefill": dict(dtype="bfloat16", weight_format="int8", M=256,
                            N=4096, K=4096)},
    }
    rows = rows + quant_rows + tree_rows

    def pick(mine, want):
        return next(r for r in mine
                    if all(r.get(k) == v for k, v in want.items()))

    for name, m in meta.items():
        mine = [r for r in rows if r["name"] == name]
        main = pick(mine, m["main"])
        entry = {"name": name, "route": "cuda",
                 "source": m.get("source", "paddle_tpu_torch/kernels/"
                                           "csrc/decode_attention.cu"),
                 "replaces": m["replaces"],
                 "tpu_counterpart": m["tpu_counterpart"],
                 "launches": m["launches"][name],
                 "max_abs_err": max(r["max_abs_err"] for r in mine),
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"],
                 "ok": all(r["ok"] for r in mine)}
        if "body" in main:
            entry["body"] = main["body"]
        if "bundle" in m:
            # the bundle shape beside the decode shape: a 256-token
            # prefill chunk (K6, K7) or the [4, 2, 2] verify (K8)
            b = pick(mine, m["bundle"])
            entry["bundle"] = {k: b[k] for k in (
                "q_len", "B", "body", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err")}
        if "prefill" in m:
            # K9 at a 256-token prefill chunk (the wgmma body)
            b = pick(mine, m["prefill"])
            entry["prefill"] = {k: b[k] for k in (
                "M", "body", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
        # the same kernel at GPT-3 1.3B's shape (its main-path case)
        gmain = dict(m["main"], **({"N": 2048, "K": 2048}
                                   if "M" in m["main"] else {}))
        gmain.pop("pool", None)
        g = pick([r for r in gpt_rows if r["name"] == name], gmain)
        entry["gpt_launches"] = m["gpt_launches"].get(name, 0)
        if name in http_launches:
            entry["http_launches"] = http_launches[name]
        if name in router_launches:
            entry["router_launches"] = router_launches[name]
        entry["gpt"] = {k: g[k] for k in (
            "B", "q_len", "M", "N", "K", "body", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err") if k in g}
        entry["max_abs_err"] = max(entry["max_abs_err"], g["max_abs_err"])
        entry["ok"] = entry["ok"] and all(
            r["ok"] for r in gpt_rows if r["name"] == name)
        out.append(entry)
    return out


def main(argv=None) -> int:
    global _out_path
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "paddle_tpu_torch package beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.out:
        _out_path = args.out
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        open(args.out, "w").close()

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks": PEAKS})

    # the script's wall time by stretch, printed before the kernels line
    mark, timeline = part_timer()
    t_script = time.perf_counter()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(_build.SOURCES)})
    mark("build")

    # ResNet-50: K10 and K11 against their plain versions, inference
    # (K10), the train step (K11) and the fp32 card-against-CPU check
    conv_rows = conv_kernel_phase()
    infer_launches = resnet_infer_phase(kind)
    resnet_train_launches = resnet_train_phase(kind)
    resnet_parity_phase(kind)
    conv_kernels = conv_summary(conv_rows, infer_launches,
                                resnet_train_launches)
    mark("resnet")

    rng = np.random.RandomState(SEED)
    rows = kernel_phase(rng)
    quant_rows = quant_attention_phase(np.random.RandomState(SEED + 4)) \
        + quant_matmul_phase()
    qmm_host_phase()
    tree_rows = tree_kernel_phase(np.random.RandomState(SEED + 6))
    split_sweep_phase(np.random.RandomState(SEED + 8))
    flash_rows = flash_kernel_phase(rng)
    # the threefry key chain and the samplers, card against CPU
    sample_phase()
    mark("kernels")

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = seeded_llama(cfg, SEED, DEV, torch.bfloat16).eval()
    torch.cuda.synchronize()
    emit({"phase": "model", "name": "llama2_7b", "dtype": "bfloat16",
          "params": sum(p.numel() for p in model.parameters()),
          "seconds": time.perf_counter() - t0})
    # bf16 is the served configuration: its runs give the launch counts
    # and the speed, and report the teacher-forced agreement; bf16
    # rounding across 32 random layers moves logits by more than the 0.1
    # gap, so the same weights in fp32 carry the asserted check
    requests = traffic(rng, cfg.vocab_size)
    serve_launches, bf16_outputs, bf16_tps, serve_perf = serve_phase(
        model, cfg, requests, kind, strict=False)
    gen_launches = generate_phase(model, cfg, requests, kind, strict=False)
    # beside the greedy decode iteration, one where every slot samples
    plain_decode = profile_phase(model, requests, kind, sampled=True)
    # sampled serving: the same traffic with sampling parameters
    sampled_outputs, _ = serve_sample_phase(model, cfg, requests, kind,
                                            strict=False,
                                            greedy_tps=bf16_tps)
    # speculative serving: the same target with its truncated draft in
    # the chain and tree lanes (greedy, then sampled), then a profiled
    # [4, 2, 2] round
    spec_launches = serve_spec_phase(
        model, requests, {"bf16_tokens_per_s": bf16_tps,
                          "outputs": {"bf16": bf16_outputs},
                          "sampled_outputs": {"bf16_sampled":
                                              sampled_outputs}}, kind)
    spec_profile_phase(model, requests, kind, plain_decode)
    mark("llama bf16 serving")
    # the host serving stack: warmup + the loop thread, the HTTP front
    # end, drain, crash and stall, the cost of tracing
    http_launches, http_perf = http_serve_phase(
        model, cfg, requests, kind, bf16_outputs, bf16_tps, plain_decode)
    mark("http_serve")
    # above the engine: two supervised replicas behind the router, in
    # process and over HTTP, restart, failover, quarantine, SIGTERM
    router_launches = router_serve_phase(
        model, cfg, requests, kind, bf16_outputs,
        {"serve": serve_perf, **http_perf})
    mark("router_serve")
    model.float()
    torch.cuda.empty_cache()
    _, _, fp32_tps, _ = serve_phase(model, cfg, requests, kind,
                                    strict=True)
    generate_phase(model, cfg, requests, kind, strict=True)
    serve_sample_phase(model, cfg, requests, kind, strict=True,
                       greedy_tps=fp32_tps)
    del model
    torch.cuda.empty_cache()
    mark("llama fp32 serving")

    # quantized serving: the same seeded weights converted to int8 (then
    # fp8) weight-only linears over int8 (fp8) KV blocks
    quant_launches = serve_quant_phase(cfg, requests, bf16_outputs,
                                       bf16_tps, kind)
    quant_parity_phase(kind)
    spec_parity_phase(kind)
    rows += edge_phase(kind)
    mark("quantized and speculative parity")

    train_launches = train_phase(kind)
    train_parity_phase(kind)
    mark("training")

    # GPT-3 1.3B: the decode kernels and K9 at its shapes, its serving
    # lanes at full width, and the fp32 card-against-CPU checks
    gpt_rows = gpt_kernel_phase()
    gpt_requests, gpt_launches = gpt_serve_phase(kind)
    gpt_parity_phase(kind, gpt_requests)
    mark("gpt")
    emit({"phase": "timeline", "seconds": timeline,
          "total_seconds": time.perf_counter() - t_script})

    emit({"kernels": summary(rows, serve_launches, gen_launches, flash_rows,
                             train_launches, quant_rows, quant_launches,
                             tree_rows, spec_launches, gpt_rows,
                             gpt_launches, http_launches,
                             router_launches) + conv_kernels})
    emit(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
