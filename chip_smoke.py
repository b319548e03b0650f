#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out FILE]

Phases, each printing JSON lines (and failing loudly on any check):

1. ``device``: the card's name, its power limit from nvidia-smi, the
   torch and CUDA versions.
2. ``build``: nvcc builds every CUDA source of the port from this
   checkout (all sources in parallel).
3. ``kernel``: every kernel of the serving and training paths against
   its plain PyTorch version on the card, bf16 (atol 2e-2) and fp32
   (atol 1e-4); with the kernel's time (CUDA events over many launches
   after a warm-up), the plain version's time, the time of
   ``F.scaled_dot_product_attention`` on the same inputs (a yardstick
   the port never calls: forward for K1 and the decode kernels, its
   backward for K2 and K3), and the least time the card could take
   (``bound_ms``, by bytes or by operations). The decode kernels run at
   the serving shapes; the flash-attention kernels K1-K3 compare out,
   lse, dq, dk and dv at ``FLASH_SHAPES`` (the training shape in bf16
   and fp32, Llama-2-7B's heads, non-causal, segment ids, s = 1000).
4. ``serve``: Llama-2-7B at full width and depth, bf16, seeded random
   N(0, 0.02) weights made on the card, served by the paged engine
   (8 slots, max_len 2048, 16-token blocks, 256-token prefill chunks):
   12 greedy requests, prompts of 48 to 1500 tokens, four sharing a
   512-token prefix. Checks: every request completes with its token
   count; the paged kernel launched exactly layers x (decode steps +
   prefill chunks) times with no paged fallback. A second engine with
   60% of the worst-case blocks must preempt and still complete every
   request. ``generate`` on two prompts launches the contiguous kernel
   once per layer per decode step. Teacher-forced check: every emitted
   token is the argmax of the plain uncached forward over prompt +
   emitted prefix wherever that forward's top-1/top-2 gap exceeds 0.1.
   In bf16 the agreement is reported; the whole phase then runs again
   on the same weights in fp32, where the check is asserted.
   ``profile``: wall and device time of a prefill and a decode
   iteration of the bf16 engine, and the kernels that take the most.
5. ``train``: the JAX package's bench.py primary point (134M Llama,
   hidden 768, 12 layers of 12 heads, vocab 32000, flash attention) at
   full width and depth in bf16 with fp32 rope tables, seeded N(0, 0.02)
   weights, trained by ``ShardedTrainStep`` with AdamW(1e-4) on one
   repeated 16 x 1024 batch: 3 warm-up and 20 timed steps. Prints the
   losses, ms per step, tokens/s, peak memory and an MFU estimate;
   asserts finite losses, a first loss within 0.5 of ln(32000), a last
   loss below the first, and exactly 12 launches per step of each of
   K1, K2 and K3. ``profile``: one train step's wall and device time and
   top kernels. ``train_parity``: the same width at depth 2, batch 2,
   seq 256 in fp32, three steps on the card and three on the CPU (plain
   versions) from the same weights: losses agree to rtol 1e-4, every
   weight within lr and their mean difference within 1e-3 * lr.
6. ``kernels``: one summary object per kernel; then the card's
   nvidia-smi line; the last line is
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Exits non-zero, printing no result, without a GPU or outside a checkout
of the repository.
"""

from __future__ import annotations

import argparse
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


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(lens, q_len, H, KV, d, itemsize, extra_bytes,
                    dtype_name):
    """Least time for the attention of these rows: each valid K/V byte,
    q, out and the index inputs moved once, or 4*d flops per visible
    (query, key) pair at the dtype's peak, whichever is larger."""
    B = len(lens)
    nbytes = sum(lens) * KV * d * 2 * itemsize \
        + 2 * B * q_len * H * d * itemsize + extra_bytes
    pairs = sum(H * (q_len * L - q_len * (q_len - 1) // 2) for L in lens)
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
        for kernel, q_lens in (("flash_decode_attention", (1, 8)),
                               ("paged_flash_decode_attention", (1, 32, 256))):
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
                           "group": group, "head_dim": d, "max_len": max_len,
                           "block_size": bs if paged else None,
                           "pos": [int(p) for p in pos],
                           "max_abs_err": err, "atol": ATOL[dname], "ok": ok,
                           "ms": cuda_ms(run, 50),
                           "plain_ms": cuda_ms(plain, 5),
                           "library_ms": cuda_ms(lib, 20),
                           "bound_ms": bound, "bound_by": bound_by}
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


def flash_bound(name, b, s, h, d, isz, pairs, dname):
    """Least time for one flash kernel: inputs read once, outputs written
    once, or its matrix-product operations at the dtype's peak."""
    n = b * s * h * d * isz
    stats = b * h * s * 4
    nbytes = {"flash_fwd": 4 * n + stats,             # q k v -> out, lse
              "flash_bwd_dkdv": 6 * n + 2 * stats,    # q k v do lse delta -> dk dv
              "flash_bwd_dq": 5 * n + 2 * stats}[name]
    flops = {"flash_fwd": 4, "flash_bwd_dkdv": 8, "flash_bwd_dq": 6}[name] \
        * d * pairs
    t_bytes = nbytes / PEAKS["bw"] * 1e3
    t_ops = flops / PEAKS[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_kernel_phase(rng):
    """K1-K3 against their plain versions on the same inputs, with their
    times, the plain versions' and SDPA's (forward for K1, backward for
    K2 and K3), and their bounds. Returns the rows."""
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
                   "causal": causal, "segments": with_seg,
                   "max_abs_err": e,
                   "errs": {x: errs[x] for x in checked[name]},
                   "atol": ATOL[dname], "ok": e <= ATOL[dname], "ms": ms,
                   "plain_ms": plain_ms,
                   "plain_covers": "forward" if name == "flash_fwd"
                   else "dq, dk and dv together",
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention "
                              + ("forward" if name == "flash_fwd"
                                 else "backward (dq, dk and dv together)"),
                   "bound_ms": bound, "bound_by": bound_by}
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
    kinds = {"port_kernels": 0.0, "cublas": 0.0, "other": 0.0}
    for k, t in dev:
        kind = "port_kernels" if k.startswith("void flash_") or \
            "flash_decode" in k else "cublas" if k.startswith(
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
           "kernel_launches": launches, "card": kind}
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 0.5,
          f"first loss {losses[0]} not within 0.5 of ln(vocab)")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in fa.LAUNCHES:
        check(launches[name] == L * n_steps,
              f"{name} launched {launches[name]} times, expected "
              f"{L} layers x {n_steps} steps = {L * n_steps}")
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


def traffic(rng, vocab):
    """12 greedy requests: prompts of 48..1500 tokens, four sharing a
    512-token prefix (one among the first eight admitted, three queued
    behind them so they hit the prefix cache)."""
    shared = rng.randint(1, vocab, 512)

    def prompt(n, share=False):
        tail = rng.randint(1, vocab, n - 512 if share else n)
        return list(shared) + list(tail) if share else list(tail)

    # the first eight prompts take 589 blocks of 16 tokens, and their 128
    # new tokens 64 more: an engine with 60% of the 1025 worst-case
    # blocks admits all eight and must preempt while they decode
    spec = [(1500, False, 128), (530, True, 128), (1480, False, 128),
            (1400, False, 128), (1350, False, 128), (1300, False, 128),
            (1100, False, 128), (700, False, 128), (620, True, 40),
            (800, True, 72), (1024, True, 56), (48, False, 32)]
    return [(prompt(n, s), m) for n, s, m in spec]


def serve_engine(model, requests, **overrides):
    import torch

    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(max_slots=8, max_len=2048, block_size=16,
                        prefill_chunk=256, **overrides)
    eng = ServingEngine(model, cfg, device=DEV)
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
    eng.run_until_idle()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(da.LAUNCHES)
    fallbacks = dict(da.DISPATCH_FALLBACKS)
    return eng, reqs, seconds, launches, fallbacks


def _teacher_forced_all(model, prompts, outputs, label, strict):
    """Teacher-forced check over many requests; with ``strict`` any
    confident disagreement fails, without it the count is reported."""
    checked = skipped = disagree = 0
    for i, (p, toks) in enumerate(zip(prompts, outputs)):
        c, s, bad = teacher_forced(model, p, toks)
        checked, skipped, disagree = checked + c, skipped + s, \
            disagree + len(bad)
        check(not (strict and bad),
              f"{label}: request {i} emitted tokens that are not the plain "
              f"forward's argmax (index, emitted, argmax, gap): {bad[:5]}")
    return {"teacher_forced_checked": checked,
            "teacher_forced_disagree": disagree,
            "near_ties_skipped": skipped, "teacher_forced_asserted": strict}


def serve_phase(model, cfg, requests, kind, strict):
    """Both engines (default pool, then 60% of it) over the traffic."""
    import torch

    L = cfg.num_hidden_layers
    dname = str(next(model.parameters()).dtype).split(".")[-1]
    full = 8 * (2048 // 16) + 1
    out = {}
    for label, overrides in (("default", {}),
                             ("oversubscribed",
                              {"num_blocks": int(0.6 * full)})):
        eng, reqs, secs, launches, fallbacks = serve_engine(model, requests,
                                                            **overrides)
        st = eng.stats()
        tag = f"{dname} {label}"
        for r, (p, m) in zip(reqs, requests):
            check(r.status == "completed" and len(r.output_tokens) == m,
                  f"{tag}: request {r} did not complete with {m} tokens")
        expect = L * (st["steps"] + st["prefill_chunks"])
        k6 = launches["paged_flash_decode_attention"]
        check(k6 == expect, f"{tag}: paged kernel launched {k6} times, "
                            f"expected {L} x ({st['steps']} steps + "
                            f"{st['prefill_chunks']} chunks) = {expect}")
        paged_fb = {k: v for k, v in fallbacks.items()
                    if k.startswith("paged_")}
        check(not paged_fb, f"{tag}: paged fallbacks {paged_fb}")
        if label == "oversubscribed":
            check(st["preemptions"] >= 1, f"{tag}: engine never preempted")
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
               "tokens_per_s": gen / secs, "kernel_launches": launches,
               "fallbacks": fallbacks, "card": kind}
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
            main_launches = launches
    return main_launches


def profile_phase(model, requests, kind):
    """Where a serving iteration's time goes: the first eight requests on
    a default engine, one window of prefill iterations (every slot runs a
    256-token chunk) and one of pure decode steps. Wall time per
    iteration is taken without the profiler; device time per iteration
    (the sum of kernel times on the card) from a torch.profiler trace of
    the same number of iterations."""
    import torch

    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(max_slots=8, max_len=2048, block_size=16,
                        prefill_chunk=256)
    eng = ServingEngine(model, cfg, device=DEV)
    for p, m in requests[:8]:
        eng.submit(p, max_new_tokens=m)

    def window(n):
        return device_window(eng.step, n)

    prefill = window(2)
    while any(j is not None for j in eng._jobs):
        eng.step()
    decode = window(10)
    emit({"phase": "profile", "model": "llama2_7b", "dtype": "bfloat16",
          "slots": 8, "prefill_iteration": prefill,
          "decode_iteration": decode, "card": kind})
    del eng
    torch.cuda.empty_cache()


def generate_phase(model, cfg, requests, kind, strict):
    """``generate`` on two equal-length prompts: the contiguous kernel
    serves every decode step (the 200-token prefill is declined for
    q_len and runs the plain attention)."""
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
    row = {"phase": "generate", "dtype": dname, "B": 2, "prompt_len": S,
           "new_tokens": N, "seconds": secs, "tokens_per_s": 2 * N / secs,
           "kernel_launches": launches, "fallbacks": fallbacks, "card": kind}
    row.update(_teacher_forced_all(model, prompts,
                                   [out[b, S:].tolist() for b in range(2)],
                                   f"{dname} generate", strict))
    emit(row)
    return launches


def summary(rows, serve_launches, gen_launches, flash_rows,
            train_launches):
    """One object per kernel, with the numbers of its main-path shape:
    for K1-K3 the training shape, for K4/K6 the decode step (bf16, group
    1 as in Llama-2-7B)."""
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
                    "ok": all(r["ok"] for r in mine)})
    meta = {
        "flash_decode_attention": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:491 "
                        "(_flash_decode, _decode_kernel :336)",
            "tpu_counterpart": "K4", "launches": gen_launches,
            "main": dict(dtype="bfloat16", q_len=1, group=1)},
        "paged_flash_decode_attention": {
            "replaces": "paddle_tpu/pallas_kernels/decode_attention.py:685 "
                        "(_paged_flash_decode, _decode_kernel :336)",
            "tpu_counterpart": "K6", "launches": serve_launches,
            "main": dict(dtype="bfloat16", q_len=1, group=1)},
    }
    for name, m in meta.items():
        mine = [r for r in rows if r["name"] == name]
        main = next(r for r in mine
                    if all(r[k] == v for k, v in m["main"].items()))
        out.append({"name": name, "route": "cuda",
                    "source": "paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                    "replaces": m["replaces"],
                    "tpu_counterpart": m["tpu_counterpart"],
                    "launches": m["launches"][name],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    "ok": all(r["ok"] for r in mine)})
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

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(_build.SOURCES)})

    rng = np.random.RandomState(SEED)
    rows = kernel_phase(rng)
    flash_rows = flash_kernel_phase(rng)

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
    serve_launches = serve_phase(model, cfg, requests, kind, strict=False)
    gen_launches = generate_phase(model, cfg, requests, kind, strict=False)
    profile_phase(model, requests, kind)
    model.float()
    torch.cuda.empty_cache()
    serve_phase(model, cfg, requests, kind, strict=True)
    generate_phase(model, cfg, requests, kind, strict=True)
    del model
    torch.cuda.empty_cache()

    train_launches = train_phase(kind)
    train_parity_phase(kind)

    emit({"kernels": summary(rows, serve_launches, gen_launches, flash_rows,
                             train_launches)})
    emit(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
