#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds every CUDA kernel of the port from ``incubator_mxnet_tpu_torch/
   csrc/`` (``nvcc``, into ``build/torch_kernels/``) and prints the build
   time and each kernel's register / shared-memory report; for the
   flash-attention kernels also their tensor-core instructions (SASS
   ``HGMMA``/``HMMA`` from ``cuobjdump``), failing on a register spill or
   a kernel with products but no tensor-core instruction; for the K6 and
   LayerNorm row kernels (forward and backward, every layout) their SASS
   instruction counts by opcode class, registers and spills, failing on a
   spill;
2. holds each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16: the forward kernels at the shapes of the serving
   path (flash attention also at the training step's call), the training
   kernels (flash-attention backward, fused residual +
   dropout + LayerNorm forward and backward, LayerNorm backward, dropout)
   at the shapes of the BERT-base training step, dropout masks bit for
   bit; the row backward (K4b, K3 backward) also at 65536 rows, at one
   row and at each vector count a lane can take, two calls bitwise
   equal; the row kernels also in AMP's layouts, K3 with f32 x, bf16 h
   and f32 gamma/beta (8192 and 1000 rows: equal to the f32 kernels on h
   widened to f32 bit for bit, its mask the dropout kernel's), K4 and
   K4b with bf16 x and f32 gamma/beta (8192 and 8 rows), dgamma/dbeta in
   f32 and bitwise equal across two calls; K4 at every row count the
   main paths give it (1 to 64 rows of decode steps and prefill chunks,
   800 to 2000 of prefills, 8192 of the training step); and the forward
   row kernels' result bit for bit the same whatever the call's row
   count: K4 and K3 (p = 0.1, a device key) on the first n rows alone
   against the same rows of a 65536-row call, on both sides of the row
   count past which the grid's warps walk (``ops.layer_norm.row_blocks``),
   at one row and at 8192, K3 equal to K4 on x plus the dropout mask's h;
3. checks the end-to-end output on a small input (a tiny GPT on the card
   against the same weights on the CPU) and then serves three requests
   with ``gpt2_small`` at full width (768 units, 12 layers, 12 heads,
   vocab 50257, seeded random weights) through ``GPTModel.generate``,
   counting each kernel's launches in that run, and compares the logits
   with the same path on the plain versions, teacher-forced on the
   kernel path's tokens; then serves ``gpt2_small`` through
   ``serve.ServeEngine`` (8 slots of 256 tokens, paged KV, chunked
   prefill, the decode step one CUDA graph) on ``bench.py``'s arrival
   trace (``bench_gpt_serve``) and a shared-prefix trace: one capture, a
   flat program count, a replay bit for bit its function run eagerly,
   K4 launched inside the replay (a profiled replay's device time split
   by kernel, K4's summed), every token the plain path's argmax, every
   page back after shutdown; then the same trace through engines with
   speculative decoding (k = 4: the n-gram draft, the reference bench's
   ``gpt_serve_spec``, and the target as its own draft model, each round
   a draft and a verify graph) and with the int8 KV pool (and int8 under
   the n-gram draft on 8 requests, a check only): one capture of each
   graph a run uses, a flat program count, each replay bit for bit its
   function run eagerly (the trash page left out), K4 25 times a verify
   replay and 25 k a draft replay, the page ledger after every step, the
   tokens against the f32 engine's and the plain path's argmax, the
   self-draft accepting more than 0.9 of its drafts, and the reference's
   int8 bar (first tokens exact, the divergence-free prefix, a quarter of
   the bytes a slot); then the serving plane on the same model: trace A
   through a `serve.Gateway` ([gateway A]), two co-resident models with
   tiers, tenants and preemption ([gateway]), a disaggregated prefill +
   decode pod ([disagg]), traced and faulted engines ([trace], [fault]),
   and, last of all the phases (after the timings of 7.), the elastic
   plane ([elastic]: the reference's diurnal day through
   a gateway whose autoscale advisor and elastic controller spawn, drain
   and replace replicas, against a static two-replica fleet and a
   replica killed mid-trace; no failed request, no program after a
   replica's publication, the memory of a released replica back, the
   device-memory census against the pools, the chips-hours ratio, the
   high tier's TTFT SLO, the sampler's host cost a step);
4. checks one BERT-base training step at full width (8 x 512 tokens,
   ragged ``valid_length``, dropout 0.1) on the kernels against the same
   step on the plain versions: same weights, same dropout keys, loss and
   every gradient;
5. trains BERT-base MLM as the reference's ``bench.py`` does (batch 64 x
   sequence 128, dropout 0.1, ``Trainer`` with Adam at lr 1e-4, softmax
   cross-entropy): 2 warm-up and 10 timed steps, with each kernel's
   launches counted per step, a falling loss required, and the device's
   busy time of one step from ``torch.profiler``; then the same workload
   under ``amp.init("bfloat16")`` (the reference bench's own setting),
   its launches counted per step by layout (the row kernels in AMP's
   mixed layouts, the flash kernels bf16), its device time by kernel;
   then one more run in f32 with TF32 products (a number, not a path);
   then the same workload through ``parallel.DataParallel``, the
   reference bench's own trainer (``bench.py:362``), under AMP and in
   f32: one eager step, one that captures the whole step (forward,
   backward, Adam) as a CUDA graph, and 10 timed replays; launches
   counted by kernel and layout at the eager and the capturing step and
   read back from a profiled replay (the Python counters do not move on
   a replay), one capture, the replays' losses and parameters against
   the step function run eagerly from the same state and seed (bit for
   bit), device time and idle share beside the ``Trainer`` step's; and,
   before it, K3, K5 and K6 on device keys (the keys such a step folds
   on the card from its base key, t and the dropout site) at the step's
   shapes, bit for bit the by-value launches for the same words, their
   masks the plain versions', the fold kernel's table the plain fold's,
   and a captured graph of the three dropping other elements when t
   moves between two replays;
6. drives ``npx.gelu_dropout`` (the fused exact-erf GELU + dropout
   kernel, K6, forward and backward; its gelu and gelu' no further from
   float64 than erff's form, on 2^22 points) at BERT-base's FFN width and
   the training step's token count: x (64, 128, 768) through
   ``gluon.nn.Dense(3072)``, ``npx.gelu_dropout(p=0.1, training=True)``
   and ``gluon.nn.Dense(768)``, loss (y * g).sum(), backward; the same
   weights and keys with the plain versions and with the reference's
   composed route (``impl="xla"``: ``F.gelu`` then the dropout kernel),
   exact launch counts per step, output and gradients against the plain
   path; K6 itself is first held against its plain version (f32 and
   bf16, p = 0.1 and 0, the reference's (65536, 3072) bf16 site and a
   ragged shape), its masks bit for bit the dropout kernel's;
7. times each kernel, its plain version and one PyTorch library call
   that computes the same function (a yardstick the port never calls),
   with CUDA events over CUDA-graph replays whose inputs cycle through
   copies larger than the L2 cache (a library backward pass: its
   forward-and-backward minus its forward), beside the least time the
   card could take for the same work; K4 at up to 64 rows with gamma and
   beta cycled beyond the L2 cache too (as a decode replay finds them)
   and beside its launch floor (an empty kernel on the same grid, timed
   the same way), and its wrapper's host time a call; the row backward's
   device time split by kernel (``torch.profiler``).

8. drives the reference's imperative front door on the card (``[nd]``,
   after the timings, before ``[elastic]``): NDArrays made on ``cuda:0``
   with no scope open; ``bench.py``'s dot pair (100 chained ``mx.np.dot``
   on (1024, 1024) f32 against ``torch.matmul``, one scalar fetch, the
   median of three rounds' ratios) and the funnel's host time a call;
   BERT-base's embedding, LayerNorm, dropout and one post-LN encoder
   layer at 64 x 128 composed of ``mx.np``/``npx`` calls on NDArrays
   (``nd_encoder_layer``) under ``autograd.record()`` and
   ``.backward()``, held against the port's ``BERTEncoder`` on the same
   seeded weights at p = 0 and at p = 0.1 (the same keys, checked) in
   f32 and under AMP, its launches (K1, K2, K3 both ways, K4, K4b, K5)
   exactly the module path's, and a second ``backward`` over the same
   graph bit for bit the first; K6 through ``npx.gelu_dropout(nd,
   impl="pallas")`` in f32 and bf16, bit for bit the torch-tensor call;
   and the autograd semantics (a second backward, ``grad_req="add"``,
   ``grad(create_graph=True)``, a custom ``Function``) on the card
   against the CPU.

Everything it has to say comes on earlier lines: the card's name and
power limit (``nvidia-smi``), ``{"train": ...}``, ``{"train_amp": ...}``,
``{"train_tf32": ...}``, ``{"train_dp_amp": ...}``, ``{"train_dp": ...}``,
``{"serve": ...}``, ``{"serve_engine": ...}``, ``{"serve_spec": ...}``,
the serving plane's (``{"gateway_a": ...}`` ... ``{"elastic": ...}``) and
``{"gelu_dropout": ...}``, ``{"nd": ...}`` lines, one
``{"kernels": [...]}`` line (the fold kernel of the device keys last), and
last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
and prints no result; so does a run without a CUDA device, or one
outside a checkout of the repository. TF32 is off for matmuls and cuDNN
except in the TF32 training run, which restores it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, the f32
# rate outside the tensor cores, the bf16 and TF32 tensor-core rates
PEAK_BYTES_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# f32-accurate products on the tensor cores: three TF32 products (495
# TFLOP/s dense) for each f32 product. The least time of an f32 attention
# kernel (K1, K2) counts its operations at this rate, since the card can
# do them so (K1 and K2 do, as 3xTF32); the elementwise kernels and the
# training step's share of the f32 peak keep 67 TFLOP/s.
PEAK_3XTF32 = 495e12 / 3

# kernel vs plain tolerances on the card. float32: max abs error (the same
# f32 arithmetic summed in another order). bfloat16: both sides round
# nearly the same f32 value to bf16 once, so they are equal or neighbours,
# at most one bf16 spacing (2^-7 of the plain value) apart, elementwise,
# plus the f32 difference where the value is near zero
ATTN_TOL = 1e-4
LN_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
STATS_TOL = 2e-5  # LN mean / rstd (f32 on both sides)
LSE_TOL = 1e-4
# flash attention (K1, K2) in bfloat16: the kernels round P and dS to bf16
# before the second products, as the reference does; the forward rounds P
# at its running max, the plain version at the final max. An element that
# is a sum of terms that cancel can then differ by more than one spacing
# of its own, so the check is normwise: the error's norm at most 2^-7 of
# the plain tensor's, and every element within 2^-6 of its largest
# magnitude (two bf16 spacings at the top of its range)
ATTN_BF16_NORM_TOL, ATTN_BF16_MAX_TOL = 2.0 ** -7, 2.0 ** -6
# end to end, f32: logits of the kernel path vs the plain path after 12
# layers, relative to the largest logit
LOGIT_REL_TOL = 1e-3

REQUESTS = [(8, 100, 64), (4, 500, 32), (1, 1000, 16)]  # (batch, prompt, new)
ATTN_T = (128, 512, 1000)
N, H, D, C, LAYERS, VOCAB = 8, 12, 64, 768, 12, 50257

# the training slice: BERT-base (bench.py `bench_bert_train`)
BERT_VOCAB, FFN = 30522, 3072
TRAIN_B, TRAIN_T, TRAIN_P, TRAIN_LR = 64, 128, 0.1, 1e-4
WARMUP, STEPS = 2, 10
ROWS = TRAIN_B * TRAIN_T                       # 8192 rows of C
CHECK_B, CHECK_T = 8, 512                      # the train-step check
# flash-attention backward, float32: |kernel - plain| of dq, dk, dv.
# Each is a sum over up to T = 1000 keys or rows of f32 products taken in
# another order (64-wide tiles vs one product); at these inputs
# (unit-normal q, k, v, dO) the gradients reach a few units, so their
# last bits are ~1e-6 and 1e-4 leaves two orders of magnitude.
ATTN_BWD_TOL = 1e-4
# LayerNorm / fused-block backward, float32: dx and dh are row sums over
# C = 768 in another order, like the forward: LN_TOL. dgamma and dbeta
# sum over all 8192 rows: see `ops.layer_norm.column_sum_tol`.
# The train-step check, float32: the loss within 1e-5 of itself; every
# gradient within 1e-3 of its own largest magnitude (12 layers of f32
# backward through kernels whose sums run in another order than the
# plain versions', each layer moving the last bits of its inputs).
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-3
# kernel launches of one training step of BERT-base with dropout:
# K5 = 1 embedding + 12 attention-output + 12 FFN-hidden sites, forward
# and backward; a K2 call launches 3 kernels (delta, dq, dk/dv), a K4b or
# K3 backward call 2 (row kernel, dgamma/dbeta reduction)
STEP_LAUNCHES = {"K1": 12, "K2": 12 * 3, "K4": 2, "K4b": 2 * 2, "K3f": 24,
                 "K3b": 24 * 2, "K5": 50, "K6f": 0, "K6b": 0, "fold": 0}
FWD_LAUNCHES = {"K1": 12, "K2": 0, "K4": 2, "K4b": 0, "K3f": 24, "K3b": 0,
                "K5": 25, "K6f": 0, "K6b": 0, "fold": 0}

# the row backward's own checks: NV, the 16-byte vectors a lane takes of
# a row, at counts its kernel instantiates apart, the main paths' 6 (f32)
# and 3 (bf16) among them (C = NV * 32 * vector width), at ROW_BWD_ROWS
# rows
ROW_BWD_NV = (1, 3, 6, 8, 16)
ROW_BWD_ROWS = 1000

# the K6 slice: npx.gelu_dropout at BERT-base's FFN hidden. Kernel vs
# plain, float32: max abs 2e-6 at unit-normal inputs (the kernel's
# rational normal tail and the plain version's erf each lie within ~4e-7
# of float64 there, rounded in another order). The path, float32:
# the output and every gradient within 1e-4 of its own largest magnitude
# (two 768/3072-deep matrix products around the kernel).
GD_TOL = 2e-6
GD_PATH_REL_TOL = 1e-4
GD_WARMUP, GD_STEPS = 1, 5
# K6's gelu and gelu' against float64 at this many points of [-10, 10]
GD_SWEEP = 2 ** 22 + 1
GD_RAGGED = (1000, 771)          # numel not a multiple of the vector width
GD_LARGE = (65536, FFN)          # BERT-base at sequence 512, bf16
# operations an element (f32, on the CUDA cores): an erff or expf counted
# as its ~10 multiply-adds, Philox's integer work not counted
GD_FWD_OPS, GD_BWD_OPS = 20, 40

# the serving engine (serve.ServeEngine) on gpt2_small, f32: 8 slots of
# 256 tokens, the default 16-token pages and 64-token prefill chunks.
# Trace A is bench.py's `bench_gpt_serve` (:629): 32 greedy requests,
# prompts randint(8, 64), budgets randint(48, 96), Poisson arrivals with
# a mean gap of 0.03 s, seed 0. Trace B is the shape of
# `bench_gpt_serve_prefix` (:774): 8 requests of one 128-token system
# prompt plus a unique 1-15-token tail, 6 new tokens each.
SERVE_SLOTS, SERVE_MAX_LEN = 8, 256
TRACE_A = dict(requests=32, prompt_lo=8, prompt_hi=64, new_lo=48,
               new_hi=96, gap_s=0.03, seed=0)
TRACE_B = dict(requests=8, prefix=128, tail_hi=16, new=6, seed=0)
# K4 launches of one prefill chunk or one decode step: two a layer and
# the final LayerNorm
SERVE_K4_PER_PASS = 2 * LAYERS + 1
# replays timed with CUDA events for the decode graph's device time
SERVE_REPLAYS = 20
# speculative decoding and the int8 pool on trace A (`phase_serve_spec`):
# the reference bench's `gpt_serve_spec` run (bench.py:1846-1858, k = 4,
# the n-gram draft), a self-draft (the target as its own draft model, the
# harness-overhead floor of bench.py:645) and the int8 pool without
# speculation; int8 under the n-gram draft on the first SPEC_INT8_CHECK
# requests as a check with no number
SPEC_K = 4
SPEC_INT8_CHECK = 8
# the reference's bars (tests/test_serve.py:459, :730): a self-draft's
# accept rate; the int8 tokens' divergence-free prefix against the f32
# engine's, and the int8 pool's bytes a slot against the f32 pool's
SPEC_SELF_ACCEPT = 0.9
INT8_PREFIX_SHARE, INT8_BYTES_SHARE = 0.5, 0.3
# the serving plane on gpt2_small, f32. [gateway A]: trace A through a
# one-model serve.Gateway over the [serve engine] configuration.
# [gateway]: the shape of bench.py's `bench_gpt_gateway` (:943) at full
# width: two models under one 120-page budget split 2:1, 4 slots of 128
# tokens, three tenants on three tiers, `loadgen.synth_trace` (30
# requests, seed 0), then the acceptance test's preemption episode.
# [disagg]: the shape of `bench_gpt_serve_disagg` (:1180): 1 prefill + 1
# decode replica against 2 homogeneous ones, 72 pages, 8 slots of 64
# tokens, `loadgen.mixed_length_trace` (20 requests, seed 0). [fault]:
# one serve_step fault on FAULT_REQUESTS requests of FAULT_NEW tokens.
GATEWAY = dict(total_pages=120, max_slots=4, max_len=128, requests=30,
               seed=0, duration_s=0.8, prompt_mean=20, prompt_max=60,
               max_new_range=(4, 12), warm_lens=(12, 24, 48))
GATEWAY_TENANTS = {"acme": (3.0, "high"), "beta": (2.0, "normal"),
                   "crawl": (1.0, "low")}
DISAGG = dict(total_pages=72, max_slots=8, max_len=64, requests=20, seed=0,
              duration_s=0.25, long_frac=0.3, long_prompt=30,
              long_jitter=0.1, long_new_range=(2, 4), chat_prompt_mean=8,
              chat_new_range=(20, 28), warm_lens=(8, 20, 36))
# a page of the f32 pool across the 12 layers: K and V, 12 heads x 16
# tokens x 64 x 4 bytes
PAGE_BYTES_F32 = LAYERS * 2 * H * 16 * D * 4
MIGRATION_REPS = 20
FAULT_REQUESTS, FAULT_NEW = 4, 8
# [elastic]: the shape of `bench_gpt_serve_elastic` (bench.py:1019): one
# gpt2_small model, 2 slots of 64 tokens, a 24-page cut a replica of a
# 48-page budget, at most 2 replicas, the seeded `loadgen.diurnal_trace`
# day (trough 4 s at 0.5/s, steady 4 s at 2/s, surge 4 s at 30/s, burst
# 1.5 s at 80/s; prompts mean 16 and max 36, 16-26 new tokens), the
# advisor's knobs of bench.py:1087-1089, the timeseries sampler at 0.25 s.
# The warm lengths (bench.py:1068) cover every chunk bucket (16, 32, 64):
# a resumed request (prompt + its tokens so far, up to 62) reaches 64.
ELASTIC = dict(max_slots=2, max_len=64, pages_a_replica=24, max_replicas=2,
               seed=0, trough=(4.0, 0.5), steady=(4.0, 2.0),
               surge=(4.0, 30.0), burst=(1.5, 80.0), prompt_mean=16,
               prompt_max=36, max_new_range=(16, 26),
               warm_lens=(12, 24, 48), ts_interval=0.25,
               ts_samples=8192, advisor_period=0.5,
               advisor=dict(up_occupancy=0.65, down_occupancy=0.25,
                            fast_window_s=1.5, slow_window_s=4.0,
                            cooldown_s=3.0, burst_queue=6),
               ttft_slo=(20.0, 0.6), tail_s=15.0, crash_requests=12,
               crash_at=4, sampler_requests=24)
ELASTIC_MEM_TOL = 1 << 20        # bytes: memory back after a retire


def log(*args):
    print(*args, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def input_sets(tensors, reps):
    """``tensors`` and clones of them, together more than twice the L2
    cache (at most ``reps`` sets): a timed loop that cycles through them
    reads its inputs from device memory, which is what the bound counts."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = min(reps, max(1, -(-2 * L2_BYTES // size)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def cold_sets(tensors):
    """Copies of ``tensors``, views of one buffer each, together more than
    twice the L2 cache, however small they are: a CUDA graph that makes
    one call on each set (``time_ms(fn, sets, len(sets))``) finds every
    input cold, as a decode replay finds a LayerNorm's gamma and beta
    after the weights of a layer have streamed through the cache."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = -(-2 * L2_BYTES // size)
    bufs = [t.unsqueeze(0).repeat(n, *([1] * t.dim())) for t in tensors]
    return [tuple(b[i] for b in bufs) for i in range(n)]


def time_ms(fn, sets, reps, keep=False):
    """Device time of one call of ``fn``: CUDA events around the replay of
    a CUDA graph holding ``reps`` calls (no host launch cost between
    calls) that cycle through the argument ``sets``, after an eager
    warm-up call. With ``keep``, every call's outputs stay allocated
    while the graph lives, so each call writes buffers of its own: the
    outputs, too, cycle beyond the L2 cache (else the graph's pool hands
    every call the same y, whose lines stay dirty in the L2 cache)."""
    import torch

    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            out = fn(*sets[i % len(sets)])
            if keep:
                outs.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def agree(got, ref, f32_tol):
    """(ok, max abs error, normwise relative error) of a kernel's output
    against its plain version's: float32 within ``f32_tol`` elementwise,
    bfloat16 within BF16_RTOL * |plain| + BF16_ATOL elementwise."""
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((d <= BF16_RTOL * r.abs() + BF16_ATOL).all())
    else:
        ok = d.max().item() <= f32_tol
    rel = (d.norm() / r.norm().clamp_min(1e-30)).item()
    return ok, d.max().item(), rel


def agree_attn(got, ref, f32_tol):
    """(ok, max abs error, normwise relative error, max abs error over
    the plain tensor's largest magnitude) of a K1/K2 output: float32
    within ``f32_tol`` elementwise; bfloat16 within ATTN_BF16_NORM_TOL
    normwise and ATTN_BF16_MAX_TOL of the largest magnitude."""
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    err = d.max().item()
    rel = (d.norm() / r.norm().clamp_min(1e-30)).item()
    top = err / max(r.abs().max().item(), 1e-30)
    if got.dtype == torch.bfloat16:
        ok = rel <= ATTN_BF16_NORM_TOL and top <= ATTN_BF16_MAX_TOL
    else:
        ok = err <= f32_tol
    return ok, err, rel, top


def tol_text(dtype, f32_tol, attn=False):
    if dtype == "float32":
        return f"tol {f32_tol:g}"
    if attn:
        return "tol normwise 2^-7, max 2^-6*max|plain|"
    return f"tol 2^-7*|plain| + {BF16_ATOL:g} elementwise"


def bound(bytes_moved, flops, dtype, tensor_cores=False):
    """(least ms, "bytes" or "operations"); ``tensor_cores``: f32
    operations at the 3xTF32 rate (K1, K2)."""
    rate = (PEAK_3XTF32 if tensor_cores and dtype == "float32"
            else PEAK_FLOPS[dtype])
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def live_share(lengths, t):
    """The share of rows (or keys) that ``lengths`` leaves live: a kernel
    need not read the inputs of the others."""
    if lengths is None:
        return 1.0
    return float(lengths.double().sum()) / (lengths.numel() * t)


def _cuobjdump():
    """The toolkit's ``cuobjdump``: beside ``nvcc``, else the copy in
    Triton's ``backends/nvidia/bin``; None if neither is there."""
    from pathlib import Path

    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.ops import _build

    found = []
    try:
        found.append(Path(_build._nvcc()).parent / "cuobjdump")
    except MXNetError:
        pass
    try:
        import triton

        found.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(f) for f in found if f.exists()), None)


def _flash_label(mangled):
    """'fwd f32 d<=64' for a flash kernel's mangled name, else None."""
    import re

    m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv|bwd_delta)_kernelI"
                  r"(f|13__nv_bfloat16)(?:Li(\d+)E)?", mangled)
    if m is None:
        return None
    kind = m.group(1).replace("bwd_", "")
    dt = "f32" if m.group(2) == "f" else "bf16"
    return f"{kind} {dt}" + (f" d<={m.group(3)}" if m.group(3) else "")


def _ptxas_report(log_text):
    """{mangled kernel: (registers, spill stores + loads)} from
    ``-Xptxas=-v``."""
    import re

    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            regs, _ = out.get(cur, (None, 0))
            out[cur] = (regs, int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), out.get(cur, (None, 0))[1])
    return out


def _row_layout(types, mode):
    """'f32', 'bf16', 'bf16 x, f32 gamma' or 'f32 x, bf16 h, f32 gamma'
    for a row kernel's (x, h, gamma) element types; LayerNorm (mode 0)
    has no h."""
    x, h, g = types
    if mode == "0":
        return x if x == g else f"{x} x, {g} gamma"
    return x if x == h == g else f"{x} x, {h} h, {g} gamma"


def _row_kernel_label(mangled):
    """'K6 fwd bf16 p>0', 'row fwd f32 x, bf16 h, f32 gamma NV=8 K3 drop',
    'row bwd bf16 x, f32 gamma NV=3 K4b' or 'row bwd reduce f32' for a K6
    or LayerNorm row kernel's mangled name, else None. The row kernels
    take three element types (x, h, gamma); a repeated bf16 is a
    substitution (``S1_``), float is always ``f``."""
    import re

    m = re.search(r"(gelu_dropout_kernel|ln_fwd_kernel|ln_bwd_kernel|"
                  r"ln_partials_reduce_kernel)I((?:f|13__nv_bfloat16|S\d*_)+)"
                  r"((?:L[bi]\d+E)*)", mangled)
    if m is None:
        return None
    kind = m.group(1)
    types = ["f32" if t == "f" else "bf16" for t in
             re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2))]
    vals = re.findall(r"L[bi](\d+)E", m.group(3))
    if kind == "gelu_dropout_kernel":
        drop, bwd = vals
        return (f"K6 {'bwd' if bwd == '1' else 'fwd'} {types[0]} "
                f"{'p>0' if drop == '1' else 'p=0'}")
    if kind in ("ln_fwd_kernel", "ln_bwd_kernel"):
        nv, mode = vals
        return (f"row {kind[3:6]} {_row_layout(types, mode)} NV={nv} "
                + {"0": "K4" if kind == "ln_fwd_kernel" else "K4b",
                   "1": "K3 p=0", "2": "K3 drop"}[mode])
    return f"row bwd reduce {types[0]}"


# SASS opcodes counted apart in the build phase's K6 / row-backward report
SASS_CLASSES = ("IMAD", "IMAD.WIDE", "IMAD.HI", "LOP3", "FFMA", "FMUL",
                "FADD", "FMNMX", "MUFU", "F2FP", "PRMT", "ISETP", "FSEL",
                "LDG", "STG", "SHFL", "LDS", "STS", "BRA")


def _sass_counts(text, label_of):
    """{label: {"total": n, opcode class: n}} of the kernels that
    ``label_of`` names in ``cuobjdump -sass`` output (static counts)."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = label_of(line.split("Function :")[1].strip())
            if cur:
                out[cur] = dict.fromkeys(("total",) + SASS_CLASSES, 0)
            continue
        if cur is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if m:
            out[cur]["total"] += 1
            op = m.group(1)
            for cls in SASS_CLASSES:  # "IMAD" counts IMAD.WIDE too
                if op == cls or op.startswith(cls + "."):
                    out[cur][cls] += 1
    return out


def phase_build():
    """Build every kernel; print each library's register report, for each
    flash-attention kernel its tensor-core instructions (SASS
    ``HGMMA``/``HMMA`` counts from ``cuobjdump``), registers, spills and
    shared memory, and for each K6 and LayerNorm row kernel (every layout)
    its SASS instruction count by opcode class, registers and spills.
    Fails if a flash kernel that runs products has no tensor-core
    instruction, or if a flash, K6 or row kernel spills."""
    import ctypes

    from incubator_mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    empty_lib, empty_nvcc = _start_empty_kernel_build()
    paths = _build.build_all()
    empty_log, _ = empty_nvcc.communicate()
    check(empty_nvcc.returncode == 0,
          f"nvcc failed for the empty kernel:\n{empty_log}")
    _EMPTY_LIB_PATH[:] = [empty_lib]
    log(f"[build] {len(paths)} libraries and the empty kernel's in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p.name) for p in paths.values()))
    logs = _build.build_logs()
    redesigned = ("gelu_dropout", "layer_norm", "fused_block")
    for stem, text in logs.items():
        if stem == "flash_attention" or stem in redesigned:
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {stem}: {line.strip()}")

    ptxas = {_flash_label(k): v for k, v in
             _ptxas_report(logs["flash_attention"]).items() if _flash_label(k)}
    lib = ctypes.CDLL(str(paths["flash_attention"]))
    smem = {}
    for kind, code in (("fwd", 0), ("dq", 1), ("dkv", 2)):
        for dt, dcode in (("f32", 0), ("bf16", 1)):
            for dp in (64, 128):
                smem[f"{kind} {dt} d<={dp}"] = lib.mx_flash_attention_smem(
                    code, dcode, dp)
    tool = _cuobjdump()

    def sass_of(stem):
        return subprocess.run([tool, "-sass", str(paths[stem])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    sass = {}
    if tool is None:
        log("[build] no cuobjdump found beside nvcc or in Triton; the "
            "tensor-core instruction check and the SASS counts did not run")
    else:
        cur = None
        for line in sass_of("flash_attention").splitlines():
            if "Function :" in line:
                cur = _flash_label(line.split("Function :")[1].strip())
                if cur:
                    sass[cur] = {"HGMMA": 0, "HMMA": 0}
            elif cur:
                for op in ("HGMMA", "HMMA"):
                    if f" {op}." in line or f" {op} " in line:
                        sass[cur][op] += 1
    for label in sorted(set(ptxas) | set(sass)):
        regs, spills = ptxas.get(label, (None, None))
        ops = sass.get(label)
        tc = "" if ops is None else (f"HGMMA {ops['HGMMA']}, HMMA "
                                     f"{ops['HMMA']}, ")
        extra = (f", {smem[label]} bytes of dynamic shared memory"
                 if label in smem else "")
        log(f"[build] flash_attention {label}: {tc}{regs} registers, "
            f"{spills} bytes spilled{extra}")
        if label.startswith("delta"):
            continue  # the pre-pass runs no products
        check(spills == 0, f"flash kernel {label} spills registers")
        if ops is not None:
            check(ops["HGMMA"] + ops["HMMA"] > 0,
                  f"flash kernel {label} has no tensor-core instruction")
    if tool is not None:
        check(len(sass) == 14, f"expected 14 flash kernels in the SASS, "
              f"found {sorted(sass)}")

    for stem in redesigned:
        regs = {_row_kernel_label(k): v for k, v in
                _ptxas_report(logs[stem]).items() if _row_kernel_label(k)}
        ops = {} if tool is None else _sass_counts(sass_of(stem),
                                                   _row_kernel_label)
        check(regs, f"{stem}: no K6 or row kernel in the ptxas report")
        for label in sorted(set(regs) | set(ops)):
            r, spills = regs.get(label, (None, None))
            o = ops.get(label)
            text = ("" if o is None else f"{o['total']} SASS instructions ("
                    + ", ".join(f"{k} {o[k]}" for k in SASS_CLASSES if o[k])
                    + "), ")
            log(f"[build] {stem} {label}: {text}{r} registers, {spills} "
                f"bytes spilled")
            check(spills == 0, f"{stem} kernel {label} spills registers")


def attn_cases(torch, dev):
    """K1 inputs as the prefill gives them: q, k, v strided views of one
    (N, T, 3, H, d) projection output, causal; one lengths case; and the
    BERT-base training step's call, (64, 128, 3, H, d) views, not
    causal."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, t, causal in [(N, t, True) for t in ATTN_T] + [
                (TRAIN_B, TRAIN_T, False)]:
            g = torch.Generator(device=dev).manual_seed(t)
            qkv = torch.randn(n, t, 3, H, D, generator=g, device=dev)
            cases.append(dict(base=qkv.to(dtype), lengths=None,
                              causal=causal, layout="bthd", n=n, t=t,
                              dtype=dtype))
    g = torch.Generator(device=dev).manual_seed(7)
    t = 512
    qkv = torch.randn(3, N, H, t, D, generator=g, device=dev)
    lens = torch.randint(1, t + 1, (N,), generator=g, device=dev)
    cases.append(dict(base=qkv, lengths=lens, causal=False, layout="bhtd",
                      n=N, t=t, dtype=torch.float32))
    return cases


def split_qkv(c, base):
    """q, k, v views of a case's input tensor."""
    return base.unbind(2 if c["layout"] == "bthd" else 0)


# the row counts the main paths give K4 at C = 768: GPTDecoder's decode
# steps (1, 4, 8: a batch of each request) and prefills (800, 2000, 1000),
# the serving engine's decode and draft steps (8), verify step (8 slots x
# (k + 1) = 40) and prefill chunks (16, 32, 64), the BERT-base step (8192)
SERVE_LN_ROWS = (1, 4, 8, 16, 32, 40, 64, 800, 1000, 2000, ROWS)
# the whole call whose first rows the forward row kernels' invariance
# check calls alone (the reference's BERT-base at sequence 512)
INVARIANCE_ROWS = 65536
# up to this many rows the decode replay finds gamma and beta cold (the
# weights stream through the L2 cache between two LayerNorms): time them
# so, and beside the launch floor
COLD_LN_ROWS = 64


def ln_cases(torch, dev):
    """K4 inputs at the main paths' rows (SERVE_LN_ROWS) in f32, and at
    the serving path's earlier timing rows in f32 and bf16; and in AMP's
    layout, bf16 x with f32 gamma/beta, at the training step's rows (the
    MLM LayerNorm) and at N rows."""
    from incubator_mxnet_tpu_torch.ops.layer_norm import layout_name

    f32, bf16 = torch.float32, torch.bfloat16
    rows_f32 = sorted(set(SERVE_LN_ROWS) | {N * t for t in ATTN_T})
    specs = [(f32, f32, rows) for rows in rows_f32]
    specs += [(bf16, bf16, rows) for rows in [N * t for t in ATTN_T] + [N]]
    specs += [(bf16, f32, ROWS), (bf16, f32, N)]
    cases = []
    for dtype, pdt, rows in specs:
        g = torch.Generator(device=dev).manual_seed(rows)
        x = (torch.randn(rows, C, generator=g, device=dev) * 2 + 0.5)
        gamma = 1 + 0.3 * torch.randn(C, generator=g, device=dev)
        beta = 0.3 * torch.randn(C, generator=g, device=dev)
        cases.append(dict(x=x.to(dtype), gamma=gamma.to(pdt),
                          beta=beta.to(pdt), rows=rows, dtype=dtype,
                          layout=layout_name(dtype, pdt)))
    return cases


def fwd_invariance_rows(sms):
    """The row counts at which the forward row kernels' bit-for-bit
    invariance is checked: one row, the serving engine's verify step
    (slots x (k + 1)), the training step's rows, and both sides of the
    most rows `ops.layer_norm.row_blocks` gives one warp each (past them
    the warps walk)."""
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    full = ln.ROW_WARPS * ln.ROW_BLOCKS_PER_SM * sms
    return sorted({1, SERVE_SLOTS * (SPEC_K + 1), ROWS, full, full + 1})


def phase_row_fwd_invariance(torch, dev):
    """A row's y, mean and rstd from the forward row kernels are the same
    bits whatever the call's row count and grid: K4 (f32, and AMP's
    bf16 x with f32 gamma) and K3 at p = 0.1 on a device key (f32, and
    AMP's f32 x with bf16 h) on the first n rows of a 65536-row input,
    against the same rows of the whole call, at each of
    `fwd_invariance_rows`; K3's mask the dropout kernel's."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    sms = ln.sm_count(dev)
    rows_list = fwd_invariance_rows(sms)
    big = INVARIANCE_ROWS
    f32, bf16 = torch.float32, torch.bfloat16
    key = ph.DeviceKey(torch.tensor([1414213562, 1732050807], device=dev),
                       torch.tensor(3, device=dev), 5, {})
    words = tuple(int(w) for w in ph.key_words(key))
    g = torch.Generator(device=dev).manual_seed(29)
    for name, xdt, hdt, pdt in (("K4", f32, None, f32),
                                ("K4", bf16, None, f32),
                                ("K3", f32, f32, f32),
                                ("K3", f32, bf16, f32)):
        x = (torch.randn(big, C, generator=g, device=dev) + 0.3).to(xdt)
        gamma = (1 + 0.3 * torch.randn(C, generator=g, device=dev)).to(pdt)
        beta = (0.3 * torch.randn(C, generator=g, device=dev)).to(pdt)
        if name == "K4":
            h = None

            def run(n, x=x, gamma=gamma, beta=beta):
                return ln.layer_norm_fwd(x[:n], gamma, beta, impl="kernel")
            layout = ln.layout_name(xdt, pdt)
        else:
            h = torch.randn(big, C, generator=g, device=dev).to(hdt)

            def run(n, x=x, h=h, gamma=gamma, beta=beta):
                return fb.residual_dropout_ln_fwd(
                    x[:n], h[:n], gamma, beta, key, TRAIN_P, impl="kernel")
            layout = ln.layout_name(xdt, pdt, hdt)
        whole = run(big)
        kinds = []
        for n in rows_list:
            part = run(n)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b[:n]) for a, b in zip(part, whole))
            kinds.append(f"{n}: {ln.row_blocks(n, sms)}")
            check(same, f"{name} {layout}: the first {n} rows alone differ "
                  f"from the same rows of a {big}-row call")
        if h is not None:  # the kept elements are the dropout kernel's
            keep = ph.keep_mask(h.shape, words, TRAIN_P, device=dev)
            s = x.float() + torch.where(keep, h.float() * ph.dropout_scale(
                TRAIN_P), 0.0)
            yp, mp, rp = ln.layer_norm_fwd(s, gamma, beta, impl="kernel")
            check(torch.equal(whole[1], mp) and torch.equal(whole[2], rp)
                  and torch.equal(whole[0], yp.to(xdt)),
                  f"K3 {layout}: the statistics and y differ from K4 on x "
                  f"plus the dropout mask's h")
        log(f"[row fwd] {name} {layout}"
            + (f" p={TRAIN_P} device key" if h is not None else "")
            + f": the first n rows alone = the same rows of a {big}-row "
            f"call, bit for bit, at n (8-warp blocks) "
            + ", ".join(kinds)
            + ("; K3 = K4 on x + the dropout kernel's mask on h, bit for "
               "bit" if h is not None else ""))
    return rows_list


def _dt(dtype):
    return str(dtype).replace("torch.", "")


def phase_kernels_vs_plain(torch, dev):
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    attn, lns = attn_cases(torch, dev), ln_cases(torch, dev)
    for c in attn:
        kw = dict(lengths=c["lengths"], causal=c["causal"],
                  layout=c["layout"])
        q, k, v = split_qkv(c, c["base"])
        o, lse = fa.flash_attention_with_lse(q, k, v, impl="kernel", **kw)
        op, lsep = fa.flash_attention_with_lse(q, k, v, impl="plain", **kw)
        torch.cuda.synchronize()
        ok, err, rel, top = agree_attn(o, op, ATTN_TOL)
        fin = torch.isfinite(lsep)
        check(torch.equal(fin, torch.isfinite(lse)),
              f"K1 lse +inf rows differ ({c['t']}, {_dt(c['dtype'])})")
        lse_err = (lse[fin] - lsep[fin]).abs().max().item()
        c.update(max_abs_err=err, norm_rel_err=rel, lse_err=lse_err)
        log(f"[K1] N={c['n']} T={c['t']} {_dt(c['dtype'])} "
            f"causal={c['causal']} lengths={c['lengths'] is not None}: "
            f"max|o-plain|={err:.3e}, /max|plain|={top:.3e}, "
            f"|o-plain|/|plain|={rel:.3e} "
            f"({tol_text(_dt(c['dtype']), ATTN_TOL, attn=True)}: "
            f"{'ok' if ok else 'EXCEEDED'}), "
            f"max|lse-plain|={lse_err:.3e} (tol {LSE_TOL:g})")
        check(ok and lse_err <= LSE_TOL, "K1 disagrees with plain")
    for c in lns:
        y, m, r = ln.layer_norm_fwd(c["x"], c["gamma"], c["beta"],
                                    impl="kernel")
        yp, mp, rp = ln.layer_norm_fwd(c["x"], c["gamma"], c["beta"],
                                       impl="plain")
        torch.cuda.synchronize()
        ok, err, rel = agree(y, yp, LN_TOL)
        serr = max((m - mp).abs().max().item(), (r - rp).abs().max().item())
        c.update(max_abs_err=err, norm_rel_err=rel, stats_err=serr)
        log(f"[K4] ({c['rows']}, {C}) {c['layout']}: "
            f"max|y-plain|={err:.3e} ({tol_text(_dt(c['dtype']), LN_TOL)}: "
            f"{'ok' if ok else 'EXCEEDED'}), |y-plain|/|plain|={rel:.3e}, "
            f"max|stats-plain|={serr:.3e} (tol {STATS_TOL:g})")
        check(ok and serr <= STATS_TOL, "K4 disagrees with plain")
    return attn, lns


def phase_small_reference(torch, dev):
    """End to end on a small input: a tiny GPT with the same weights on
    the card (kernels) and on the CPU (plain versions)."""
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny

    cpu = gpt_tiny(vocab_size=97, max_length=64, dropout=0.0, device="cpu",
                   seed=3)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.normal_(0, 0.35, generator=g)
    gpu = gpt_tiny(vocab_size=97, max_length=64, dropout=0.0, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 97, (2, 12), generator=g)
    got = gpu.generate(x.to(dev), 20).cpu()
    ref = cpu.generate(x, 20)
    with torch.no_grad():
        err = (gpu(got.to(dev)).cpu() - cpu(got)).abs().max().item()
    log(f"[small] tiny GPT card vs CPU: greedy tokens identical="
        f"{torch.equal(got, ref)}, max|logits diff|={err:.3e} (tol 1e-4)")
    check(torch.equal(got, ref) and err <= 1e-4,
          "tiny GPT on the card disagrees with the CPU")


def decode_step_device_ms(torch, model, prompt, cont):
    """Device time of one decode step (all layers, after the prompt's
    prefill), without the host's launch cost: the step is captured in a
    CUDA graph and replayed."""
    from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder

    dec = GPTDecoder(model)
    with torch.no_grad():
        _, padded, t0, ck, cv = dec._start(prompt, 2)
        dec._prefill(padded, t0, ck, cv)
        return time_ms(lambda: dec._step(cont[:, 0], t0, ck, cv), [()], 10)


def phase_serve(torch, dev):
    from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    model = gpt2_small(device=dev, seed=0).eval()
    g = torch.Generator(device=dev).manual_seed(1234)
    model.generate(torch.randint(0, VOCAB, (1, 16), generator=g, device=dev),
                   2)  # warm-up: library handles, allocator
    torch.cuda.synchronize()
    launches = {"K1": 0, "K4": 0}
    results = []
    for batch, t0, new in REQUESTS:
        prompt = torch.randint(0, VOCAB, (batch, t0), generator=g,
                               device=dev)
        torch.cuda.synchronize()
        fa.launches = 0
        ln.launches = 0
        start = time.perf_counter()
        out = model.generate(prompt, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        k1, k4 = fa.launches, ln.launches
        launches["K1"] += k1
        launches["K4"] += k4
        exp_k1, exp_k4 = LAYERS, (2 * LAYERS + 1) * new
        log(f"[serve] batch {batch} x prompt {t0} -> {new} new: "
            f"wall {wall * 1e3:.1f} ms, {batch * new / wall:.1f} tokens/s, "
            f"launches K1={k1} (expected {exp_k1}) K4={k4} "
            f"(expected {exp_k4})")
        check(k1 == exp_k1 and k4 == exp_k4, "unexpected launch counts")
        check(out.shape == (batch, t0 + new)
              and torch.equal(out[:, :t0], prompt)
              and int(out.min()) >= 0 and int(out.max()) < VOCAB,
              "generate returned malformed tokens")
        cont = out[:, t0:]
        start = time.perf_counter()
        GPTDecoder(model).score(prompt, cont[:, :1])  # the prefill alone
        torch.cuda.synchronize()
        prefill = time.perf_counter() - start
        step_ms = (wall - prefill) / max(new - 1, 1) * 1e3
        dev_step_ms = decode_step_device_ms(torch, model, prompt, cont)
        log(f"[serve]   prefill {prefill * 1e3:.1f} ms, then "
            f"{step_ms:.2f} ms per decode step of which the device is busy "
            f"{dev_step_ms:.3f} ms (one step replayed as a CUDA graph): "
            f"device idle share {1 - dev_step_ms / step_ms:.3f}")
        lk = GPTDecoder(model, impl="kernel").score(prompt, cont)
        lp = GPTDecoder(model, impl="plain").score(prompt, cont)
        plain_out = GPTDecoder(model, impl="plain").generate(prompt, new)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lk).all()), "non-finite logits")
        scale = max(1.0, lp.abs().max().item())
        err_prefill = (lk[:, 0] - lp[:, 0]).abs().max().item()
        err_decode = ((lk[:, 1:] - lp[:, 1:]).abs().max().item()
                      if new > 1 else 0.0)
        agree = (plain_out[:, t0:] == cont).float().mean().item()
        log(f"[serve]   logits kernel vs plain: prefill max|d|="
            f"{err_prefill:.3e}, teacher-forced decode max|d|="
            f"{err_decode:.3e} (tol {LOGIT_REL_TOL:g} x {scale:.2f}); "
            f"greedy token agreement with the plain path {agree:.4f}")
        check(max(err_prefill, err_decode) <= LOGIT_REL_TOL * scale,
              "serving logits disagree with the plain path")
        results.append(dict(batch=batch, prompt=t0, new=new,
                            wall_ms=wall * 1e3, prefill_ms=prefill * 1e3,
                            decode_step_ms=step_ms,
                            decode_step_device_ms=dev_step_ms,
                            tokens_per_s=batch * new / wall,
                            k1_launches=k1, k4_launches=k4,
                            logit_err_prefill=err_prefill,
                            logit_err_decode=err_decode,
                            greedy_agreement=agree))
    return launches, results


def _serve_trace_a(onp):
    """Trace A's prompts, budgets and arrival times (bench_gpt_serve's
    draws, in its order)."""
    t = TRACE_A
    rng = onp.random.RandomState(t["seed"])
    prompts = [rng.randint(0, VOCAB, (int(rng.randint(t["prompt_lo"],
                                                      t["prompt_hi"])),))
               .astype(onp.int32) for _ in range(t["requests"])]
    budgets = [int(rng.randint(t["new_lo"], t["new_hi"]))
               for _ in range(t["requests"])]
    arrivals = onp.cumsum(rng.exponential(t["gap_s"], t["requests"]))
    return prompts, budgets, arrivals


def _serve_trace_b(onp):
    """Trace B's prompts: one system prompt and a unique tail each."""
    t = TRACE_B
    rng = onp.random.RandomState(t["seed"])
    system = rng.randint(0, VOCAB, (t["prefix"],)).astype(onp.int32)
    return [onp.concatenate([system, rng.randint(
        0, VOCAB, (int(rng.randint(1, t["tail_hi"])),)).astype(onp.int32)])
        for _ in range(t["requests"])]


def replay_device_ms(torch, slots, name="decode", reps=SERVE_REPLAYS):
    """Device time of one replay of the engine's ``name`` graph (decode,
    verify or draft): CUDA events around ``reps`` replays on the graph's
    current inputs."""
    graph = slots._graphs[name][0]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_replay(torch, slots, name="decode"):
    """(launches of the port's kernels, device ms, {kernel: device us}) of
    one profiled replay of the engine's ``name`` graph, after a spin on
    the card (so tracing is running when the replay starts)."""
    from torch.profiler import ProfilerActivity, profile

    graph = slots._graphs[name][0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        graph.replay()
        torch.cuda.synchronize()
    counts, _ = _profile_counts(prof)
    return (counts, _device_ms(prof, skip=SPIN_KERNEL),
            _device_us_by_kernel(prof, skip=SPIN_KERNEL))


def _device_us_by_kernel(prof, skip=None):
    """{kernel name: device us} of a profiled window; the LayerNorm
    forward row kernels named "K4 ..." (mode 0) or "K3 ..."."""
    import re

    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or (skip and skip in e.key):
            continue
        name = e.key.split("(")[0].replace("void ", "")
        row = re.search(r"ln_fwd_kernel<([^>]*)>", e.key)
        if row:
            name = ("K4 " if int(row.group(1).split(",")[-1]) == 0
                    else "K3 ") + name
        out[name] = out.get(name, 0.0) + getattr(
            e, "self_device_time_total",
            getattr(e, "self_cuda_time_total", 0.0))
    return out


def replay_vs_eager(torch, slots, name, args, trash=True, read=None):
    """The engine's ``name`` graph replayed, and the function it captured
    run eagerly on the same static inputs ``args`` from the same (cloned)
    pools: (outputs equal, pool leaves equal, leaves the step wrote).
    With ``trash=False`` page 0 is left out: the rows of inactive slots
    and the rows past a slot's limit all write the trash page, an
    index_put with duplicate indices whose order is unspecified on CUDA.
    ``read`` (bool, the output's shape) keeps the outputs the scheduler
    reads: a verify or draft row past its slot's limit attends to the
    trash page, so its token is not the same run to run, and the
    scheduler never reads it."""
    graph, out = slots._graphs[name]
    pools = slots._pool_leaves()
    before = [t.clone() for t in pools]
    graph.replay()
    replayed = out.clone()
    after = [t.clone() for t in pools]
    for t, b in zip(pools, before):
        t.copy_(b)
    eager = getattr(slots, f"_{name}_fn")(*args)
    torch.cuda.synchronize()
    lo = 0 if trash else 1
    leaves = sum(not torch.equal(a[lo:], b[lo:])
                 for a, b in zip(after, before))
    if read is not None:
        replayed, eager = replayed[read], eager[read]
    return (torch.equal(replayed, eager),
            all(torch.equal(a[lo:], t[lo:]) for a, t in zip(after, pools)),
            leaves)


def decode_host_split(torch, slots, sched, reps=SERVE_REPLAYS):
    """Host wall (ms) of the parts of a decode step, each alone over
    ``reps`` calls: the weight fingerprint, the input upload, the graph's
    launch (the call returns before the card finishes), and a replay with
    the token fetch that waits for it."""
    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e3

    graph, graph_out = slots._graphs["decode"]

    def launch():
        graph.replay()
        torch.cuda.synchronize()

    def launch_only():
        t0 = time.perf_counter()
        graph.replay()
        launched.append(time.perf_counter() - t0)
        torch.cuda.synchronize()

    launched = []
    out = dict(
        fingerprint=ms(slots._fingerprint),
        load_inputs=ms(lambda: slots._load_step(
            sched._last, sched._pos, sched._active, (0, 0), sched._temps)),
        replay_and_fetch=ms(lambda: (graph.replay(), graph_out.cpu())),
        replay_and_sync=ms(launch))
    for _ in range(reps):
        launch_only()
    out["replay_launch"] = sum(launched) / reps * 1e3
    return out


def prefill_chunk_device_ms(torch, slots, bucket):
    """Device time of one prefill chunk of ``bucket`` tokens without the
    host's launch cost (`time_ms`: CUDA-graph replays), its pages all the
    trash page."""
    ints = torch.zeros(bucket, dtype=torch.int64, device=slots._device)
    rows = torch.zeros(slots.pages_per_slot, dtype=torch.int64,
                       device=slots._device)
    pages = torch.zeros(bucket // slots.page_tokens, dtype=torch.int64,
                        device=slots._device)
    return time_ms(lambda: slots._prefill_fn(ints, rows, pages, 0, bucket,
                                             None, None), [()], 10)


def _timed(fn, walls):
    """``fn`` with each call's host wall time (s) appended to ``walls``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        walls.append(time.perf_counter() - t0)
        return out
    return call


def _serve_warmup(engine, prompts):
    """bench_gpt_serve's warm-up (16 and 48 tokens of the first prompt:
    the 48-token one reuses the 16-token one's first page, so it runs one
    32-token chunk), and 48 tokens of the second prompt, so every chunk
    bucket (16, 32, 64) is seen before the trace; three requests of two
    tokens, so every step's graph runs eagerly, is captured and replays.
    Returns the seconds it took."""
    import numpy as onp
    import torch

    t0 = time.perf_counter()
    for warm in (onp.resize(prompts[0], 16), onp.resize(prompts[0], 48),
                 onp.resize(prompts[1], 48)):
        engine.generate(warm, 2)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _serve_trace(engine, trace, after_step=None):
    """Trace A through the bench's own submit/step loop: each request
    submitted at its arrival time, the engine stepped in between.
    ``after_step()`` runs after every step. Returns (handles, seconds,
    slot occupancy samples)."""
    from incubator_mxnet_tpu_torch.telemetry import registry

    prompts, budgets, arrivals = trace
    occ_gauge = registry.gauge("mx_serve_slot_occupancy")
    handles, occ = [], []
    i = 0
    t0 = time.perf_counter()
    while i < len(prompts) or not all(h.done for h in handles):
        now = time.perf_counter() - t0
        while i < len(prompts) and arrivals[i] <= now:
            handles.append(engine.submit(prompts[i], budgets[i]))
            i += 1
        progressed = engine.step()
        if after_step is not None:
            after_step()
        if handles:
            occ.append(float(occ_gauge.value or 0.0))
        if not progressed and i < len(prompts):
            wait = arrivals[i] - (time.perf_counter() - t0) \
                if arrivals[i] > now else 0.001
            time.sleep(min(0.001, max(0.0, wait)))
    t_total = time.perf_counter() - t0
    failed = [h for h in handles if h.error is not None]
    check(not failed and all(h.done for h in handles),
          f"trace A: {len(failed)} of {len(handles)} requests failed")
    return handles, t_total, occ


def _fill_slots(engine, prompts, new):
    """Submit one request of ``new`` tokens a slot and step until every
    slot decodes: the state at which the replays are checked and timed.
    Returns the handles."""
    sched = engine._sched
    handles = [engine.submit(p, new) for p in prompts[:SERVE_SLOTS]]
    while not all(sched._active) and not any(h.done for h in handles):
        engine.step()
    engine.step()
    return handles


def _plain_gap(plain, dev, prompt, tokens):
    """(largest gap between the plain path's top logit and the served
    token's, the logits' scale) over a request's tokens, teacher-forced
    through the plain path."""
    import numpy as onp
    import torch

    toks = torch.tensor(tokens, device=dev)[None]
    p = torch.from_numpy(prompt[None].astype(onp.int64)).to(dev)
    lp = plain.score(p, toks)[0]
    check(bool(torch.isfinite(lp).all()), "non-finite plain logits")
    gap = (lp.max(dim=-1).values
           - lp.gather(-1, toks[0][:, None])[:, 0]).max().item()
    return gap, max(1.0, lp.abs().max().item())


def phase_serve_engine(torch, dev):
    """serve.ServeEngine on gpt2_small (full width and depth, f32, seeded
    random weights): trace A through the bench's submit/step loop after
    its warm-up, a replay checked bit for bit against the function it
    captured, trace B's shared prefix; every token held to the plain
    path's teacher-forced logits. Returns (the phase's numbers, K4
    launches through the wrapper, what `phase_serve_spec` compares with:
    the model, trace A's tokens a request, tokens/s, the decode replay's
    device ms and the f32 pool's bytes a slot)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small
    from incubator_mxnet_tpu_torch.telemetry import registry

    model = gpt2_small(device=dev, seed=0).eval()
    engine = serve.ServeEngine(model, max_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN)
    slots = engine._sched.slots
    decode_walls, chunk_walls, chunk_starts = [], {}, []
    decode_step, prefill_step = slots.decode_step, slots.prefill_chunk_step

    def prefill_recorded(slot, chunk_tokens, t_start, *args, **kwargs):
        t0 = time.perf_counter()
        out = prefill_step(slot, chunk_tokens, t_start, *args, **kwargs)
        chunk_walls.setdefault(out[1], []).append(time.perf_counter() - t0)
        chunk_starts.append(int(t_start))
        return out

    slots.decode_step = _timed(decode_step, decode_walls)
    slots.prefill_chunk_step = prefill_recorded
    chunks = registry.counter("mx_serve_prefill_chunks_total")
    hits = registry.counter("mx_serve_prefix_hits_total")
    trace = _serve_trace_a(onp)
    prompts = trace[0]

    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value
    warm_s = _serve_warmup(engine, prompts)
    count_warm = engine.xla_program_count()
    check(slots.captures == 1, "the warm-up did not capture the decode "
          "graph once")
    del decode_walls[:]
    chunk_walls.clear()

    # trace A: the bench's own loop
    handles, t_total, occ = _serve_trace(engine, trace)
    count_a = engine.xla_program_count()
    tokens = sum(len(h.tokens) for h in handles)
    ttft = onp.array([h.ttft for h in handles]) * 1e3
    step_ms = onp.array(decode_walls) * 1e3
    chunk_ms = {b: float(onp.median(w) * 1e3)
                for b, w in sorted(chunk_walls.items())}

    # a replay against the function it captured, at a state with every
    # slot decoding
    checks = _fill_slots(engine, prompts, 24)
    kv_bytes = slots.kv_bytes_per_slot
    # the next step's inputs (the last step's would rewrite what it wrote)
    sched = engine._sched
    args = slots._load_step(sched._last, sched._pos, sched._active,
                            sched._next_key(), sched._temps)
    k4_before = read_counts()["K4"]
    same_tokens, same_pools, written = replay_vs_eager(torch, slots,
                                                       "decode", args)
    check_k4 = read_counts()["K4"] - k4_before
    log(f"[serve engine] a replay vs its function run eagerly from cloned "
        f"pools on the same inputs: tokens equal={same_tokens}, all "
        f"{len(slots._pk) * 2} pool leaves equal={same_pools} ({written} "
        f"written by the step)")
    check(same_tokens and same_pools and written > 0,
          "the decode graph's replay differs from its function run eagerly")
    replay_ms = replay_device_ms(torch, slots)
    prof_counts, prof_ms, by_kernel = profiled_replay(torch, slots)
    k4_us = sum(us for k, us in by_kernel.items() if k.startswith("K4 "))
    host_split = decode_host_split(torch, slots, sched)
    chunk_dev = {b: prefill_chunk_device_ms(torch, slots, b)
                 for b in slots.chunk_buckets}
    # the checks' and timings' launches through the wrapper are not the
    # path's
    measure_k4 = read_counts()["K4"] - k4_before
    engine._drive_until(checks)

    # trace B: the bench's prefix warm-up caches the system prompt, then
    # every request attaches its pages and prefills only its tail
    prompts_b = _serve_trace_b(onp)
    half = TRACE_B["prefix"] // 2 + 3
    for warm in (prompts_b[0][:7], prompts_b[0][:half], prompts_b[0]):
        engine.generate(warm, 2)
    hits0, starts0 = hits.value, len(chunk_starts)
    handles_b = [engine.submit(p, TRACE_B["new"]) for p in prompts_b]
    engine._drive_until(handles_b)
    hits_b = hits.value - hits0
    offset_chunks = sum(t > 0 for t in chunk_starts[starts0:])
    check(all(h.error is None for h in handles_b), "trace B failed")
    torch.cuda.synchronize()
    launches = read_counts()
    launches["K4"] -= measure_k4
    n_chunks = chunks.value - chunks0
    count_b = engine.xla_program_count()
    captures = slots.captures
    engine.shutdown(drain=True)
    used = slots.allocator.used_pages

    # every token against the plain path's teacher-forced logits
    plain = GPTDecoder(model, impl="plain")
    kernel_dec = GPTDecoder(model)
    worst, agree, total = 0.0, 0, 0
    for p, h in zip(prompts + prompts_b, handles + handles_b):
        gap, scale = _plain_gap(plain, dev, p, h.tokens)
        prompt = torch.from_numpy(p[None].astype(onp.int64)).to(dev)
        toks = torch.tensor(h.tokens, device=dev)[None]
        check(gap <= LOGIT_REL_TOL * scale,
              f"request {h.id}: a token is not the argmax of the plain "
              f"path's logits (gap {gap:.3e}, tol {LOGIT_REL_TOL:g} x "
              f"{scale:.2f})")
        worst = max(worst, gap / scale)
        ref = kernel_dec.generate(prompt, len(h.tokens))[0, p.size:]
        agree += int((ref == toks[0]).sum())
        total += len(h.tokens)

    expected_k4 = SERVE_K4_PER_PASS * (n_chunks + 2)
    out = dict(
        model="gpt2_small", dtype="float32", slots=SERVE_SLOTS,
        max_len=SERVE_MAX_LEN, page_tokens=slots.page_tokens,
        prefill_chunk=slots.prefill_chunk, warmup_s=warm_s,
        trace_a=dict(TRACE_A, tokens=tokens, seconds=t_total,
                     tokens_per_s=tokens / t_total,
                     ttft_p50_ms=float(onp.percentile(ttft, 50)),
                     ttft_p99_ms=float(onp.percentile(ttft, 99)),
                     mean_slot_occupancy=float(onp.mean(occ)),
                     decode_steps=len(step_ms),
                     decode_step_wall_ms_median=float(onp.median(step_ms)),
                     decode_step_wall_ms_mean=float(step_ms.mean()),
                     replay_device_ms=replay_ms,
                     profiled_replay_device_ms=prof_ms,
                     idle_share=1 - replay_ms / float(onp.median(step_ms)),
                     decode_step_host_split_ms=host_split,
                     prefill_chunk_ms_median_by_bucket=chunk_ms,
                     prefill_chunk_device_ms_by_bucket=chunk_dev),
        trace_b=dict(TRACE_B, prefix_hits=hits_b,
                     chunks_with_offset=offset_chunks,
                     tokens=sum(len(h.tokens) for h in handles_b)),
        program_count=dict(after_warmup=count_warm, after_trace_a=count_a,
                           after_trace_b=count_b),
        captures=captures, replay_k4_launches=prof_counts["K4"],
        replay_k4_device_us=k4_us, replay_device_us_by_kernel=by_kernel,
        k4_launches_through_wrapper=launches["K4"],
        k4_launches_expected=expected_k4, prefill_chunks=n_chunks,
        worst_token_gap_rel=worst,
        token_agreement_with_gpt_decoder=agree / total,
        pages_used_after_shutdown=used)
    log(f"[serve engine] trace A: {tokens} tokens of {len(handles)} "
        f"requests in {t_total:.3f} s: {tokens / t_total:.1f} tokens/s, "
        f"TTFT p50 {out['trace_a']['ttft_p50_ms']:.2f} ms p99 "
        f"{out['trace_a']['ttft_p99_ms']:.2f} ms, mean slot occupancy "
        f"{out['trace_a']['mean_slot_occupancy']:.3f}")
    log(f"[serve engine]   decode step: wall median "
        f"{out['trace_a']['decode_step_wall_ms_median']:.3f} ms (mean "
        f"{out['trace_a']['decode_step_wall_ms_mean']:.3f}, "
        f"{len(step_ms)} steps), one replay's device time {replay_ms:.4f} "
        f"ms (CUDA events; profiled {prof_ms:.4f}): idle share "
        f"{out['trace_a']['idle_share']:.3f}; prefill chunk wall median "
        f"by bucket {chunk_ms} ms")
    log("[serve engine]   one profiled replay by kernel (device us, the "
        "8 largest): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(by_kernel.items(),
                                              key=lambda kv: -kv[1])[:8]))
    log("[serve engine]   a decode step's parts alone (host wall, ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in host_split.items())
        + "; a prefill chunk's device time by bucket (graph replays, ms): "
        + ", ".join(f"{b}: {v:.4f}" for b, v in chunk_dev.items()))
    log(f"[serve engine] trace B: {len(handles_b)} requests, prefix hits "
        f"{hits_b}, chunks with t_start > 0: {offset_chunks}")
    log(f"[serve engine] program count {count_warm} after warm-up, "
        f"{count_a} after trace A, {count_b} after trace B; captures "
        f"{captures}; K4 in a profiled replay {prof_counts['K4']} (expected "
        f"{SERVE_K4_PER_PASS}, {k4_us:.2f} us of device time together), "
        f"through the wrapper {launches['K4']} "
        f"(expected {expected_k4}: {n_chunks} chunks, the eager first "
        f"step, the capture); worst token gap {worst:.3e} of the plain "
        f"logits' scale (tol {LOGIT_REL_TOL:g}); token agreement with "
        f"GPTDecoder.generate one at a time {agree / total:.4f}; pages in "
        f"use after shutdown {used}")
    check(count_warm == count_a == count_b,
          "the program count moved after the warm-up")
    check(captures == 1, f"the decode graph was captured {captures} times")
    check(prof_counts["K4"] == SERVE_K4_PER_PASS,
          "a replay did not launch K4 at every LayerNorm")
    check(launches["K4"] == expected_k4 and check_k4 == SERVE_K4_PER_PASS,
          "unexpected K4 launches through the wrapper")
    check(hits_b == TRACE_B["requests"] and offset_chunks >= hits_b,
          "trace B did not reuse the system prompt's pages")
    check(used == 0, f"{used} pages still in use after shutdown")
    base = dict(model=model, tokens=[list(h.tokens) for h in handles],
                tokens_per_s=tokens / t_total, replay_ms=replay_ms,
                kv_bytes_per_slot=kv_bytes,
                ttft_p50_ms=out["trace_a"]["ttft_p50_ms"],
                ttft_p99_ms=out["trace_a"]["ttft_p99_ms"],
                decode_step_wall_ms=out["trace_a"][
                    "decode_step_wall_ms_median"],
                host_split=host_split)
    return out, launches["K4"], base


def _read_rows(pos, active, limit, n):
    """Which of a verify's (``n`` = k + 1) or a draft's (``n`` = k)
    outputs the scheduler reads: an inactive slot's (its own tokens) and
    an active slot's rows at positions up to its limit (the room it
    accepts from); bool (S, n) on the host."""
    import numpy as onp
    import torch

    p = onp.asarray(pos)[:, None] + onp.arange(n)
    return torch.from_numpy(~onp.asarray(active, bool)[:, None]
                            | (p <= onp.asarray(limit)[:, None]))


def _spec_inputs_now(slots, sched):
    """A speculative round's inputs at the scheduler's state without its
    page extension: each slot's limit its last mapped position (rows past
    it write the trash page), the drafts its last token repeated."""
    import numpy as onp

    pt = slots.page_tokens
    limit = onp.array([len(r.pages) * pt - 1 if r is not None and a else 0
                       for r, a in zip(sched._in_slot, sched._active)])
    drafts = onp.repeat(sched._last[:, None], slots.spec_k, axis=1)
    return sched._last, drafts, sched._pos, sched._active, limit


def _write_pages_disjoint(slots, pos, active, limit, rows):
    """Fail unless the active slots' write pages (``rows`` positions from
    ``pos``, those within ``limit``) are mapped and no two slots share
    one: the int8 write is an index_put of whole pages, and only the
    trash page may take duplicate writes."""
    import numpy as onp

    pt = slots.page_tokens
    seen = set()
    for s in onp.flatnonzero(active):
        p = onp.arange(int(pos[s]), min(int(pos[s]) + rows - 1,
                                        int(limit[s])) + 1)
        pages = set(slots._table[s, p // pt].tolist())
        check(0 not in pages and not pages & seen,
              f"slot {s}: its write pages {sorted(pages)} are the trash "
              "page or another active slot's")
        seen |= pages


def int8_write_ms(torch, slots, reps=SERVE_REPLAYS):
    """Device time of the int8 decode step's 2L token writes alone (grow
    the page scale, re-quantize the page, write the token: the page
    re-quantization), at the decode graph's current inputs, on copies of
    the pools: one graph of ``reps`` steps' writes."""
    S, pt = slots.max_slots, slots.page_tokens
    step, table = slots._step_dev, slots._table_dev
    pos, active = step[S:2 * S], step[2 * S:3 * S] != 0
    rows = torch.arange(S, device=table.device)
    wpage = torch.where(active, table[rows, pos // pt], 0)
    woff = pos % pt
    planes = [(p.clone(), sc.clone())
              for pools, scales in ((slots._pk, slots._sk),
                                    (slots._pv, slots._sv))
              for p, sc in zip(pools, scales)]
    _, H, _, d = planes[0][0].shape
    g = torch.Generator(device=table.device).manual_seed(5)
    t = torch.randn(S, H, d, generator=g, device=table.device)

    def writes():
        for pool, scale in planes:
            slots._write_token(pool, scale, wpage, woff, t)

    return time_ms(writes, [()], reps)


def _serve_spec_run(torch, dev, run, kw, trace, base, first=None):
    """One engine over trace A (the bench's warm-up and loop; with
    ``first``, its first ``first`` requests submitted at once), every
    check of `phase_serve_spec` on the way. Returns (the run's numbers,
    K4 launches through the wrapper on its path)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
    from incubator_mxnet_tpu_torch.telemetry import registry

    model = base["model"]
    draft = kw.get("draft")
    engine = serve.ServeEngine(model, max_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN, **kw)
    slots, sched = engine._sched.slots, engine._sched
    pt, k = slots.page_tokens, slots.spec_k
    model_draft = slots.draft_kind == "model"
    walls = {n: [] for n in ("verify", "draft", "decode", "propose",
                             "checks")}
    verify = _timed(slots.spec_verify_step, walls["verify"])
    decode = _timed(slots.decode_step, walls["decode"])
    checks = _timed(_write_pages_disjoint, walls["checks"])

    def verify_checked(last, drafts, pos, active, limit):
        checks(slots, pos, active, limit, k + 1)
        return verify(last, drafts, pos, active, limit)

    def decode_checked(last, pos, active, key, temps):
        checks(slots, pos, active, pos, 1)
        return decode(last, pos, active, key, temps)

    slots.spec_verify_step = verify_checked
    slots.spec_draft_step = _timed(slots.spec_draft_step, walls["draft"])
    slots.decode_step = decode_checked
    slots.spec_propose = _timed(slots.spec_propose, walls["propose"])
    alloc = slots.allocator

    def ledger():
        check(alloc.free_pages >= sched._spec_reserved_total(),
              f"{run}: {alloc.free_pages} free pages under "
              f"{sched._spec_reserved_total()} reserved")
        # a decoding slot holds the page of every position it wrote and
        # none past its position's page; after a round whose tokens end on
        # a page boundary the page of pos is mapped by the next round's
        # extension, before its write (the reference's scheduler)
        for s, req in enumerate(sched._in_slot):
            if req is not None and sched._active[s]:
                pos = int(sched._pos[s])
                check((pos - 1) // pt + 1 <= len(req.pages) <= pos // pt + 1,
                      f"{run}: slot {s} holds {len(req.pages)} pages at "
                      f"position {pos}")

    pages_ok = _timed(ledger, walls["checks"])

    chunks = registry.counter("mx_serve_prefill_chunks_total")
    prompts, budgets, _ = trace
    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value
    if first is None:
        warm_s = _serve_warmup(engine, prompts)
        count_warm = engine.xla_program_count()
        for w in walls.values():
            del w[:]
        handles, t_total, occ = _serve_trace(
            engine, trace, pages_ok if k else None)
        count_trace = engine.xla_program_count()
    else:
        handles = [engine.submit(p, b) for p, b in
                   zip(prompts[:first], budgets[:first])]
        while not all(h.done for h in handles):
            engine.step()
            pages_ok()
        check(all(h.error is None for h in handles), f"{run} failed")
    path_k4 = read_counts()["K4"]
    n_chunks = chunks.value - chunks0
    out = dict(run=run, **{key: (v if isinstance(v, (int, str)) else
                                 "GPTDecoder(gpt2_small)")
                           for key, v in kw.items()})
    names = ["verify", "draft"] if model_draft else \
        ["verify"] if k else ["decode"]
    if first is None:
        tokens = sum(len(h.tokens) for h in handles)
        ttft = onp.array([h.ttft for h in handles]) * 1e3
        # the replays against their functions and their times, at a state
        # with every slot decoding
        fills = _fill_slots(engine, prompts, 24)
        k4_before = read_counts()["K4"]
        if k:
            last, drafts, pos, active, limit = _spec_inputs_now(slots, sched)
            loads = {"verify": (last, drafts, pos, active, limit),
                     "draft": (last, None, pos, active, limit)}
        dev_ms, by_kernel, prof_k4 = {}, {}, {}
        for name in names:
            read = None
            if k:
                args = slots._load_spec(*loads[name])
                read = _read_rows(pos, active, limit,
                                  k + (name == "verify")).to(dev)
            else:
                args = slots._load_step(sched._last, sched._pos,
                                        sched._active, sched._next_key(),
                                        sched._temps)
            same, pools_same, written = replay_vs_eager(
                torch, slots, name, args, trash=False, read=read)
            log(f"[serve spec] {run}: a {name} replay vs its function run "
                f"eagerly from cloned pools on the same inputs: outputs "
                + (f"the scheduler reads ({int(read.sum())} of "
                   f"{read.numel()}) " if read is not None else "")
                + f"equal={same}, every pool leaf but the trash page equal="
                f"{pools_same} ({written} written)")
            check(same and pools_same and written > 0,
                  f"{run}: the {name} graph's replay differs from its "
                  "function run eagerly")
            dev_ms[name] = replay_device_ms(torch, slots, name)
            counts, _, by_kernel[name] = profiled_replay(torch, slots, name)
            prof_k4[name] = counts["K4"]
        measure_k4 = read_counts()["K4"] - k4_before
        mem = torch.cuda.memory_allocated()
        write_ms = int8_write_ms(torch, slots) if slots._int8 else None
        engine._drive_until(fills)
        pages_ok()
    captures = dict(slots.captures_by_step)
    stats = engine.spec_stats()
    kv_bytes = slots.kv_bytes_per_slot
    engine.shutdown(drain=True)
    used = alloc.used_pages
    check(used == 0, f"{run}: {used} pages still in use after shutdown")
    expected_caps = {n: int(n in names) for n in ("decode", "verify",
                                                  "draft")}
    check(captures == expected_caps,
          f"{run}: captures {captures}, expected {expected_caps}")

    # every token against the f32 engine's (phase_serve_engine) and, where
    # it differs, against the plain path's teacher-forced logits (the same
    # tokens were checked there)
    same_tokens, total, worst, rechecked = 0, 0, 0.0, 0
    prefix, first_ok, first_n = 0, True, 0
    plain = GPTDecoder(model, impl="plain")
    for i, h in enumerate(handles):
        ref = base["tokens"][i]
        n = 0
        while n < len(ref) and n < len(h.tokens) and h.tokens[n] == ref[n]:
            n += 1
        same_tokens += sum(a == b for a, b in zip(h.tokens, ref))
        total += len(ref)
        prefix += n
        check(len(h.tokens) == len(ref) and all(
            0 <= t < VOCAB for t in h.tokens), f"{run}: request {h.id} "
            "returned malformed tokens")
        if slots._int8:
            if h.shared_tokens == 0:   # a single chunk, no cached prefix
                first_n += 1
                first_ok &= h.tokens[0] == ref[0]
        elif h.tokens != ref:
            gap, scale = _plain_gap(plain, dev, prompts[i], h.tokens)
            rechecked += 1
            worst = max(worst, gap / scale)
            check(gap <= LOGIT_REL_TOL * scale,
                  f"{run}: request {h.id}: a token is not the argmax of the "
                  f"plain path's logits (gap {gap:.3e}, tol "
                  f"{LOGIT_REL_TOL:g} x {scale:.2f})")
    expected_k4 = SERVE_K4_PER_PASS * (
        n_chunks * (2 if model_draft else 1)
        + 2 * sum(k if n == "draft" else 1 for n in names))
    out.update(tokens_equal_to_f32_engine=same_tokens, tokens=total,
               captures=captures, pages_used_after_shutdown=used,
               prefill_chunks=n_chunks, k4_launches_through_wrapper=path_k4,
               k4_launches_expected=expected_k4 if first is None else None)
    log(f"[serve spec] {run}: {same_tokens} of {total} tokens equal to the "
        f"f32 engine's ({len(handles)} requests); "
        + (f"first token equal in {first_n} requests without a cached "
           f"prefix: {first_ok}; divergence-free prefix {prefix / total:.3f}"
           f" (bar {INT8_PREFIX_SHARE})" if slots._int8 else
           f"{rechecked} requests differ, each token within "
           f"{LOGIT_REL_TOL:g} of the plain path's argmax (worst "
           f"{worst:.3e})")
        + f"; captures {captures}; K4 through the wrapper {path_k4}; "
        f"pages in use after shutdown {used}")
    check(path_k4 > 0, f"{run}: K4 was not launched on the path")
    if slots._int8:
        check(first_ok, f"{run}: a single-chunk prompt's first token "
              "differs from the f32 engine's")
        check(prefix / total >= INT8_PREFIX_SHARE,
              f"{run}: int8 drift too large: {prefix}/{total}")
        check(kv_bytes < INT8_BYTES_SHARE * base["kv_bytes_per_slot"],
              f"{run}: {kv_bytes} bytes a slot, not under "
              f"{INT8_BYTES_SHARE} of the f32 pool's "
              f"{base['kv_bytes_per_slot']}")
        out.update(first_token_checked=first_n,
                   divergence_free_prefix=prefix / total,
                   kv_bytes_per_slot=kv_bytes,
                   kv_bytes_per_slot_f32=base["kv_bytes_per_slot"])
    else:
        out.update(worst_token_gap_rel=worst, requests_rechecked=rechecked)
    if k:
        out.update(spec_stats=stats, accept_rate=stats["accept_rate"])
        if model_draft and draft is not None:
            check(stats["accept_rate"] > SPEC_SELF_ACCEPT,
                  f"{run}: accept rate {stats['accept_rate']}, not above "
                  f"{SPEC_SELF_ACCEPT}")
    if first is not None:
        return out, path_k4

    check(count_warm == count_trace,
          f"{run}: the program count moved after the warm-up "
          f"({count_warm} -> {count_trace})")
    check(path_k4 == expected_k4, f"{run}: {path_k4} K4 launches through "
          f"the wrapper, expected {expected_k4}")
    for name in names:
        want = SERVE_K4_PER_PASS * (k if name == "draft" else 1)
        check(prof_k4[name] == want, f"{run}: a profiled {name} replay "
              f"launched {prof_k4[name]} K4, expected {want}")
    k4_us = {n: sum(us for key, us in by_kernel[n].items()
                    if key.startswith("K4 ")) for n in names}
    step_walls = {n: float(onp.median(walls[n]) * 1e3) for n in names}
    out.update(
        tokens_per_s=tokens / t_total, seconds=t_total, warmup_s=warm_s,
        vs_base=tokens / t_total / base["tokens_per_s"],
        ttft_p50_ms=float(onp.percentile(ttft, 50)),
        ttft_p99_ms=float(onp.percentile(ttft, 99)),
        mean_slot_occupancy=float(onp.mean(occ)),
        # the host's page checks after every step, inside the trace's wall
        page_checks_s=float(sum(walls["checks"])),
        program_count=dict(after_warmup=count_warm, after_trace=count_trace),
        steps={n: len(walls[n]) for n in names},
        step_wall_ms_median=step_walls, replay_device_ms=dev_ms,
        idle_share=1 - sum(dev_ms.values()) / sum(step_walls.values()),
        replay_k4_launches=prof_k4, replay_k4_device_us=k4_us,
        replay_device_us_by_kernel={
            n: dict(sorted(v.items(), key=lambda kv: -kv[1])[:8])
            for n, v in by_kernel.items()},
        memory_allocated_after_captures=mem)
    if k and not model_draft:
        out["propose_host_ms_median"] = float(onp.median(walls["propose"])
                                              * 1e3)
    if write_ms is not None:
        out.update(page_write_device_ms=write_ms,
                   page_write_share=write_ms / dev_ms["decode"],
                   replay_device_ms_f32=base["replay_ms"],
                   vs_f32_replay=dev_ms["decode"] / base["replay_ms"])
    log(f"[serve spec] {run}: {tokens} tokens of {len(handles)} requests in "
        f"{t_total:.3f} s: {out['tokens_per_s']:.1f} tokens/s "
        f"({out['vs_base']:.3f} of the f32 engine's), TTFT p50 "
        f"{out['ttft_p50_ms']:.2f} ms p99 {out['ttft_p99_ms']:.2f} ms; "
        f"{out['steps']} steps, wall median {step_walls} ms, one replay's "
        f"device time {dev_ms} ms: idle share {out['idle_share']:.3f}; K4 in "
        f"a profiled replay {prof_k4} ({k4_us} us); program count "
        f"{count_warm} -> {count_trace}; memory allocated {mem} bytes"
        + (f"; accept rate {stats['accept_rate']:.4f}" if k else "")
        + (f"; n-gram proposal {out['propose_host_ms_median']:.4f} ms a "
           "round on the host" if "propose_host_ms_median" in out else "")
        + (f"; the page re-quantization {write_ms:.4f} ms of the replay's "
           f"{dev_ms['decode']:.4f} ({out['page_write_share']:.3f}), the f32 "
           f"replay {base['replay_ms']:.4f} ms" if write_ms is not None
           else ""))
    return out, path_k4


def phase_serve_spec(torch, dev, base):
    """serve.ServeEngine on gpt2_small (the model of `phase_serve_engine`)
    with speculative decoding and the int8 pool, on trace A after the
    bench's warm-up: (a) the n-gram draft, k = 4; (b) the target as its
    own draft model; (c) the int8 pool, no speculation; (d) the int8 pool
    under the n-gram draft on the first requests, a check only. Checks:
    one capture of each graph the run uses and a flat program count; a
    verify, draft or decode replay bit for bit its function run eagerly
    (the trash page left out); K4 25 times a verify replay and 25 k a
    draft replay; after every step the page ledger (free pages at least
    the reservations, each decoding slot the pages of the positions it
    wrote and none past its position's page)
    and no two active slots on one write page; every page back after
    shutdown; (a), (b): every token the plain path's argmax within
    LOGIT_REL_TOL, (b) accepting more than 0.9 of its drafts; (c), (d):
    the reference's int8 bar against the f32 engine's tokens. Returns
    (the phase's numbers, K4 launches through the wrapper)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder

    trace = _serve_trace_a(onp)
    runs = [("ngram", dict(spec_k=SPEC_K, draft="ngram"), None),
            ("self_draft", dict(spec_k=SPEC_K,
                                draft=GPTDecoder(base["model"])), None),
            ("int8", dict(kv_dtype="int8"), None),
            ("int8_ngram", dict(kv_dtype="int8", spec_k=SPEC_K,
                                draft="ngram"), SPEC_INT8_CHECK)]
    out, k4 = {}, 0
    for run, kw, first in runs:
        out[run], n = _serve_spec_run(torch, dev, run, kw, trace, base,
                                      first)
        k4 += n
        torch.cuda.empty_cache()
    return out, k4


# -- the serving plane on one card ---------------------------------------------

def _loadgen():
    """``tools/loadgen.py`` (numpy only; in neither package), loaded from
    the checkout as bench.py loads it (:960-964)."""
    import os

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    try:
        import loadgen
    finally:
        sys.path.pop(0)
    return loadgen


def _page_ledger(slots, sched, what):
    """The page ledger of one engine between steps: every page's refcount
    is the references its owners hold (the requests in its slots, the
    prefilled segments waiting for the migration plane, the prefix
    cache's entries), and the free pages cover the reservations."""
    import numpy as onp

    alloc = slots.allocator
    want = onp.zeros(alloc.n_pages, onp.int64)
    for req in list(sched._in_slot) + list(sched._prefilled):
        if req is not None and req.pages:
            onp.add.at(want, onp.asarray(req.pages, onp.int64), 1)
    for e in slots.prefix_cache._entries.values():
        onp.add.at(want, onp.asarray(e.pages, onp.int64), 1)
    bad = onp.nonzero(want[1:] != alloc._ref[1:])[0]
    check(not bad.size, f"{what}: pages {list(bad[:8] + 1)} hold "
          f"{list(alloc._ref[bad[:8] + 1])} references, their owners "
          f"{list(want[bad[:8] + 1])}")
    check(alloc.free_pages >= sched._spec_reserved_total(),
          f"{what}: {alloc.free_pages} free pages under the reservations")


def _gateway_ledger(gw, what):
    for m in gw._models.values():
        for rep in m.replicas:
            _page_ledger(rep.slots, rep.sched, f"{what} {rep.label}")


def _checked_steps(gw, what, walls):
    """Make ``gw.step`` check every engine's page ledger after each step
    (`loadgen.replay` and ``_drive_until`` step through the attribute);
    the checks' host time goes to ``walls``."""
    step = gw.step
    ledger = _timed(lambda: _gateway_ledger(gw, what), walls)

    def checked():
        out = step()
        ledger()
        return out

    gw.step = checked


def _engines(gw):
    return [rep for m in gw._models.values() for rep in m.replicas]


def _plane_k4(what, reps, chunks, k4):
    """The serving plane's K4 launches through the wrapper against their
    count: 25 a prefill chunk, and 25 for each graph's eager step and 25
    for its capture (a replay launches through no wrapper)."""
    captures = sum(rep.slots.captures for rep in reps)
    want = SERVE_K4_PER_PASS * (chunks + 2 * captures)
    check(k4 > 0, f"{what}: K4 was not launched on the path")
    check(k4 == want, f"{what}: {k4} K4 launches through the wrapper, "
          f"expected {want} ({chunks} chunks, {captures} captures)")
    return want


def _pct(values, q):
    import numpy as onp

    return float(onp.percentile(onp.asarray(values, float), q)) \
        if len(values) else None


def _trace_a_run(torch, base, kind, traced=False):
    """One run of trace A, after the bench's warm-up, through a fresh
    `ServeEngine` (``kind="engine"``, the [serve engine] configuration)
    or a one-model `Gateway` over one (``"gateway"``), each request
    submitted at its arrival and the front door stepped in between; with
    ``traced``, span tracing is on for the trace (not the warm-up). Every
    token is checked against the bare engine's of `phase_serve_engine`,
    and the program count and the pages after shutdown. Returns (numbers,
    the run's slots, its handles, its finished spans if traced). The
    numbers split the run's wall: the front door's steps, the engine's
    steps inside them, the decode steps and prefill chunks inside those,
    and the wall outside any step (waiting for arrivals)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.telemetry import tracing

    prompts, budgets, arrivals = _serve_trace_a(onp)
    model = base["model"]
    if kind == "engine":
        door = serve.ServeEngine(model, max_slots=SERVE_SLOTS,
                                 max_len=SERVE_MAX_LEN)
        sched = door._sched

        def submit(i):
            return door.submit(prompts[i], budgets[i])

        def warm(p):
            door.generate(p, 2)

        def queued():
            return sched.queue_depth

        def programs():
            return door.xla_program_count()
    else:
        reg = serve.ModelRegistry()
        reg.add("gpt2", model, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        door = serve.Gateway(reg)
        sched = door._models["gpt2"].replicas[0].sched

        def submit(i):
            return door.submit("gpt2", prompts[i], budgets[i])

        def warm(p):
            door.generate("gpt2", p, 2)

        def queued():
            return door.queue_depth + sched.queue_depth

        def programs():
            return door.xla_program_counts()["gpt2"]
    slots = sched.slots
    walls = {n: [] for n in ("step", "engine", "decode", "prefill")}
    sched.step = _timed(sched.step, walls["engine"])
    slots.decode_step = _timed(slots.decode_step, walls["decode"])
    slots.prefill_chunk_step = _timed(slots.prefill_chunk_step,
                                      walls["prefill"])
    step = _timed(door.step, walls["step"])
    for p in (onp.resize(prompts[0], 16), onp.resize(prompts[0], 48),
              onp.resize(prompts[1], 48)):
        warm(p)
    torch.cuda.synchronize()
    count_warm = programs()
    for w in walls.values():
        del w[:]
    spans = None
    if traced:
        tracing.reset()
        tracing.enable()
    try:
        handles, depth, busy, i = [], [], [], 0
        t0 = time.perf_counter()
        while i < len(prompts) or not all(h.done for h in handles):
            now = time.perf_counter() - t0
            while i < len(prompts) and arrivals[i] <= now:
                handles.append(submit(i))
                i += 1
            progressed = step()
            depth.append(queued())
            busy.append(sched.n_active)
            if not progressed and i < len(prompts):
                wait = arrivals[i] - (time.perf_counter() - t0) \
                    if arrivals[i] > now else 0.001
                time.sleep(min(0.001, max(0.0, wait)))
        t_total = time.perf_counter() - t0
        host = decode_host_split(torch, slots, sched)
        if traced:
            spans = tracing.finished_spans()
    finally:
        if traced:
            tracing.disable()
            tracing.reset()
    count_trace = programs()
    what = f"[{'trace' if traced else kind}] {kind}"
    check(all(h.error is None and h.done for h in handles),
          f"{what}: a request failed")
    door.shutdown(drain=True)
    used = slots.allocator.used_pages
    same = sum(a == b for h, ref in zip(handles, base["tokens"])
               for a, b in zip(h.tokens, ref))
    total = sum(len(ref) for ref in base["tokens"])
    tokens = sum(len(h.tokens) for h in handles)
    check(same == total and tokens == total,
          f"{what}: {same} of {total} tokens equal to the engine's")
    check(count_warm == count_trace, f"{what}: the program count moved")
    check(slots.captures == 1, f"{what}: {slots.captures} captures")
    check(used == 0, f"{what}: {used} pages in use after shutdown")
    sums = {n: float(sum(w)) for n, w in walls.items()}
    ttft = [h.ttft * 1e3 for h in handles]
    n = len(walls["step"])
    out = dict(
        kind=kind, traced=traced, tokens=tokens, tokens_equal=same,
        seconds=t_total, tokens_per_s=tokens / t_total,
        ttft_p50_ms=_pct(ttft, 50), ttft_p99_ms=_pct(ttft, 99),
        steps=n, decode_steps=len(walls["decode"]),
        prefill_chunks=len(walls["prefill"]),
        mean_queued=float(onp.mean(depth)),
        mean_slot_occupancy=float(onp.mean(busy)) / SERVE_SLOTS,
        # where the run's wall went, ms a step
        door_host_ms_a_step=(sums["step"] - sums["engine"]) / n * 1e3,
        scheduler_host_ms_a_step=(sums["engine"] - sums["decode"]
                                  - sums["prefill"]) / n * 1e3,
        decode_ms_a_decode_step=sums["decode"]
        / max(len(walls["decode"]), 1) * 1e3,
        prefill_ms_a_chunk=sums["prefill"]
        / max(len(walls["prefill"]), 1) * 1e3,
        outside_steps_s=t_total - sums["step"],
        decode_step_host_split_ms=host)
    return out, slots, handles, spans


def _run_text(r):
    return (f"{r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.2f} ms p99 {r['ttft_p99_ms']:.2f}, "
            f"{r['steps']} steps ({r['decode_steps']} decode, "
            f"{r['prefill_chunks']} chunks), queued {r['mean_queued']:.2f},"
            f" occupancy {r['mean_slot_occupancy']:.3f}; ms a step: front "
            f"door {r['door_host_ms_a_step']:.4f}, scheduler "
            f"{r['scheduler_host_ms_a_step']:.4f}; decode step "
            f"{r['decode_ms_a_decode_step']:.4f} ms, chunk "
            f"{r['prefill_ms_a_chunk']:.4f} ms; outside steps "
            f"{r['outside_steps_s']:.4f} s")


def phase_gateway_a(torch, dev, base):
    """Trace A through a one-model `serve.Gateway` over the engine of
    `phase_serve_engine` (gpt2_small, f32, 8 slots of 256 tokens), in
    turns with the bare engine (engine, gateway, gateway, engine: host
    time varies run to run, so the two are compared only within the
    phase), each a fresh front door after the bench's warm-up, each
    request submitted at its arrival: every token equal to the bare
    engine's, one capture and a flat program count a run, exact K4
    launches, every page back; tokens/s and TTFT (submit to first token)
    beside the bare engine's, and each run's wall split by layer.
    Returns (the phase's numbers, K4 launches through the wrapper)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch.telemetry import registry

    chunks = registry.counter("mx_serve_prefill_chunks_total")
    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value
    runs, reps = [], []
    for kind in ("engine", "gateway", "gateway", "engine"):
        out, slots, _, _ = _trace_a_run(torch, base, kind)
        runs.append(out)
        reps.append(SimpleNamespace(slots=slots))
        log(f"[gateway A] {kind}: {out['tokens_equal']} of {out['tokens']} "
            f"tokens equal to the bare engine's; " + _run_text(out))
    k4 = read_counts()["K4"]
    want_k4 = _plane_k4("[gateway A]", reps, chunks.value - chunks0, k4)

    def med(kind, key):
        return float(onp.median([r[key] for r in runs if r["kind"] == kind]))

    summary = {key: {k: med(k, key) for k in ("engine", "gateway")}
               for key in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                           "door_host_ms_a_step",
                           "scheduler_host_ms_a_step")}
    out = dict(model="gpt2_small", dtype="float32", slots=SERVE_SLOTS,
               max_len=SERVE_MAX_LEN, order=[r["kind"] for r in runs],
               runs=runs, medians=summary,
               vs_engine=summary["tokens_per_s"]["gateway"]
               / summary["tokens_per_s"]["engine"],
               k4_launches_through_wrapper=k4, k4_launches_expected=want_k4)
    log(f"[gateway A] medians of two runs each: tokens/s gateway "
        f"{summary['tokens_per_s']['gateway']:.1f} against the engine's "
        f"{summary['tokens_per_s']['engine']:.1f} ({out['vs_engine']:.3f});"
        f" TTFT p50 {summary['ttft_p50_ms']['gateway']:.2f} against "
        f"{summary['ttft_p50_ms']['engine']:.2f} ms, p99 "
        f"{summary['ttft_p99_ms']['gateway']:.2f} against "
        f"{summary['ttft_p99_ms']['engine']:.2f}; the gateway's own host "
        f"{summary['door_host_ms_a_step']['gateway']:.4f} ms a step; K4 "
        f"through the wrapper {k4} (expected {want_k4})")
    return out, k4


def phase_gateway(torch, dev, base):
    """The shape of the reference's `bench_gpt_gateway` (bench.py:943) at
    full width: two co-resident gpt2_small models (weight seeds 0 and 1,
    f32) under one 120-page budget split 2:1, 4 slots of 128 tokens each,
    tenants acme (weight 3, high), beta (2, normal) and crawl (1, low) on
    `loadgen.synth_trace` (30 requests, seed 0) replayed by
    `loadgen.replay`; then the acceptance test's deterministic episode
    (tests/test_gateway.py:558-580, at 4 slots: four low requests of 20
    tokens fill gpt-a, a high one preempts exactly one, every low one
    finishes its 20 tokens with those from before the preemption kept).
    After every step, every engine's page ledger; no failed request,
    program counts flat after the warm-up, exact K4 launches, every page
    back after shutdown. Returns (the phase's numbers, K4 launches)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small
    from incubator_mxnet_tpu_torch.telemetry import registry

    loadgen = _loadgen()
    g = GATEWAY
    models = {"gpt-a": base["model"],
              "gpt-b": gpt2_small(device=dev, seed=1).eval()}
    reg = serve.ModelRegistry(total_pages=g["total_pages"])
    for name, share in (("gpt-a", 2.0), ("gpt-b", 1.0)):
        reg.add(name, models[name], share=share, max_slots=g["max_slots"],
                max_len=g["max_len"])
    gw = serve.Gateway(reg, tenants={t: {"weight": w} for t, (w, _)
                                     in GATEWAY_TENANTS.items()})
    check_walls = []
    _checked_steps(gw, "[gateway]", check_walls)
    chunks = registry.counter("mx_serve_prefill_chunks_total")
    rng = onp.random.RandomState(g["seed"])
    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value
    for name in models:
        for n in g["warm_lens"]:
            gw.generate(name, rng.randint(0, VOCAB, (n,)), 2)
    programs_warm = gw.xla_program_counts()
    pages = {n: m.slots.allocator.usable_pages
             for n, m in gw._models.items()}
    events = loadgen.synth_trace(
        g["requests"], models={"gpt-a": 2.0, "gpt-b": 1.0},
        tenants=GATEWAY_TENANTS, seed=g["seed"],
        duration_s=g["duration_s"], prompt_mean=g["prompt_mean"],
        prompt_max=g["prompt_max"], max_new_range=g["max_new_range"])
    del check_walls[:]
    report = loadgen.replay(gw, events, VOCAB, timeout=120.0)
    programs_trace = gw.xla_program_counts()
    check(not report["failed"], f"[gateway]: {len(report['failed'])} "
          f"requests failed, first {report['failed'][:1]}")
    check(report["completed"] == len(events),
          f"[gateway]: {report['completed']} of {len(events)} completed")
    tiers = {t: dict(count=v["count"], ttft_p50_ms=_pct(
        [x * 1e3 for x in v["ttft"]], 50), ttft_p99_ms=_pct(
        [x * 1e3 for x in v["ttft"]], 99)) for t, v in
        report["per_tier"].items()}
    tenants = {t: v["tokens"] / report["wall_s"]
               for t, v in report["per_tenant"].items()}

    # the deterministic episode: the lows fill gpt-a's slots, a high
    # arrival preempts one, every low finishes with its tokens kept
    pre0 = gw.preemptions_total
    lows = [gw.submit("gpt-a", onp.random.RandomState(70 + i).randint(
        0, VOCAB, (6,)), 20, tenant="crawl", priority="low")
        for i in range(g["max_slots"])]
    while not all(r.tokens for r in lows):
        gw.step()
    kept = {r.id: list(r.tokens) for r in lows}
    high = gw.submit("gpt-a", onp.random.RandomState(99).randint(
        0, VOCAB, (8,)), 4, tenant="acme", priority="high")
    gw.step()
    episode_preemptions = gw.preemptions_total - pre0
    gw._drive_until(lows + [high], timeout=120.0)
    victims = [r for r in lows if r.preemptions]
    programs_end = gw.xla_program_counts()
    k4 = read_counts()["K4"]
    n_chunks = chunks.value - chunks0
    reps = _engines(gw)
    want_k4 = _plane_k4("[gateway]", reps, n_chunks, k4)
    captures = {rep.label: rep.slots.captures for rep in reps}
    gw.shutdown(drain=True)
    used = {rep.label: rep.slots.allocator.used_pages for rep in reps}
    out = dict(
        models=["gpt2_small seed 0", "gpt2_small seed 1"], dtype="float32",
        total_pages=g["total_pages"], usable_pages=pages,
        max_slots=g["max_slots"], max_len=g["max_len"],
        requests=len(events), completed=report["completed"],
        wall_s=report["wall_s"], tiers=tiers, tenant_tokens_per_s=tenants,
        preemptions=report["preemptions"],
        resumed_completed=report["resumed_completed"],
        episode=dict(preemptions=episode_preemptions,
                     victims=len(victims),
                     low_tokens=[len(r.tokens) for r in lows],
                     high_tokens=len(high.tokens)),
        program_counts=dict(after_warmup=programs_warm,
                            after_trace=programs_trace,
                            after_episode=programs_end),
        captures=captures, page_checks_s=float(sum(check_walls)),
        prefill_chunks=n_chunks, k4_launches_through_wrapper=k4,
        k4_launches_expected=want_k4, pages_used_after_shutdown=used)
    log(f"[gateway] two gpt2_small models, pages {pages}: {len(events)} "
        f"requests in {report['wall_s']:.3f} s, TTFT by tier "
        + ", ".join(f"{t} p50 {v['ttft_p50_ms']:.2f} ms p99 "
                    f"{v['ttft_p99_ms']:.2f} ms ({v['count']})"
                    for t, v in tiers.items())
        + f"; preemptions {report['preemptions']}; tokens/s by tenant "
        + ", ".join(f"{t} {v:.1f}" for t, v in tenants.items()))
    log(f"[gateway] episode: {episode_preemptions} preemption(s), "
        f"{len(victims)} victim(s), low tokens "
        f"{out['episode']['low_tokens']}, high {len(high.tokens)}; program "
        f"counts {programs_warm} -> {programs_trace} -> {programs_end}; "
        f"captures {captures}; page checks {out['page_checks_s']:.4f} s "
        f"(the trace's); K4 through the wrapper {k4} (expected {want_k4}); "
        f"pages in use after shutdown {used}")
    check(episode_preemptions == 1,
          f"[gateway]: {episode_preemptions} preemptions in the episode")
    check(len(victims) == 1, f"[gateway]: {len(victims)} victims")
    for r in lows:
        check(r.state == "done" and len(r.tokens) == 20,
              f"[gateway]: low request {r.id} {r.state} with "
              f"{len(r.tokens)} tokens")
        check(r.tokens[:len(kept[r.id])] == kept[r.id],
              f"[gateway]: request {r.id} lost its tokens from before the "
              "preemption")
    check(high.state == "done" and len(high.tokens) == 4,
          "[gateway]: the high request did not finish")
    check(programs_warm == programs_trace == programs_end,
          "[gateway]: the program counts moved after the warm-up")
    check(not any(used.values()), f"[gateway]: pages in use {used}")
    return out, k4


def _disagg_gateway(serve, model, disaggregated):
    d = DISAGG
    reg = serve.ModelRegistry(total_pages=d["total_pages"])
    if disaggregated:
        reg.add("gpt", model, prefill_replicas=1, decode_replicas=1,
                max_slots=d["max_slots"], max_len=d["max_len"])
    else:
        reg.add("gpt", model, replicas=2, max_slots=d["max_slots"],
                max_len=d["max_len"])
    return serve.Gateway(reg, tenants={"archive": {"weight": 1.0},
                                       "chat": {"weight": 2.0}})


def _disagg_warm(gw, disaggregated, rng):
    """The bench's warm-up (bench.py:1236-1256): the prefill-capable
    replicas serve one request of each warm length straight through their
    schedulers (the co-located fallback must not build anything later);
    the decode replica warms only through the migration plane."""
    import numpy as onp

    m = gw._models["gpt"]
    for rep in (m.role_replicas("prefill") if disaggregated
                else m.replicas):
        for n in DISAGG["warm_lens"]:
            seg = rep.sched.submit(
                rng.randint(0, VOCAB, (n,)).astype(onp.int32), 2)
            while not seg.done:
                rep.sched.step()
    if disaggregated:
        for n in DISAGG["warm_lens"]:
            h = gw.submit("gpt", rng.randint(0, VOCAB, (n,)).astype(
                onp.int32), 3)
            gw._drive_until([h], timeout=60.0)


def _disagg_leg(gw, disaggregated, events):
    """The bench's leg (bench.py:1258-1300): each event submitted at its
    arrival, the gateway stepped, the decode-capable replicas' decoding
    slots sampled after each step. Returns (numbers, handles)."""
    import numpy as onp

    loadgen = _loadgen()
    d = DISAGG
    m = gw._models["gpt"]
    decode_reps = m.role_replicas("decode") if disaggregated else m.replicas
    programs0 = gw.xla_program_counts(per_replica=True)
    handles, samples = [], []
    t0 = time.monotonic()
    i = 0
    while i < len(events) or not all(h.done for _, h in handles):
        now = time.monotonic() - t0
        while i < len(events) and events[i].t <= now:
            e = events[i]
            plen = min(e.prompt_len, d["max_len"] - e.max_new - 1)
            handles.append((e, gw.submit(
                "gpt", onp.random.RandomState(e.seed).randint(
                    0, VOCAB, (plen,)).astype(onp.int32),
                e.max_new, tenant=e.tenant, priority=e.priority)))
            i += 1
        gw.step()
        samples.append(sum(r.sched._n_decoding for r in decode_reps)
                       / len(decode_reps))
    wall = time.monotonic() - t0
    leg = "disagg" if disaggregated else "homogeneous"
    failed = [(h.id, h.state) for _, h in handles if h.state != "done"]
    check(not failed, f"[disagg] {leg} leg: {len(failed)} requests failed")
    programs1 = gw.xla_program_counts(per_replica=True)
    check(programs1 == programs0, f"[disagg] {leg} leg: program counts "
          f"{programs0} -> {programs1}")
    chat = [h.ttft * 1e3 for e, h in handles if e.tenant == "chat"
            and h.ttft is not None]
    tokens = sum(len(h.tokens) for _, h in handles)
    out = dict(resident_mean=float(onp.mean(samples)),
               chat_ttft_p50_ms=loadgen.percentile(chat, 50),
               chat_ttft_p99_ms=loadgen.percentile(chat, 99),
               tokens=tokens, seconds=wall, tokens_per_s=tokens / wall,
               steps=len(samples), program_counts=programs1,
               replicas={h.replica for _, h in handles})
    out["replicas"] = sorted(out["replicas"])
    return out, [h for _, h in handles]


def phase_disagg(torch, dev, base):
    """The shape of the reference's `bench_gpt_serve_disagg`
    (bench.py:1180) at full width: one gpt2_small (f32, the model of
    `phase_serve_engine`) as a 1-prefill + 1-decode pod against 2
    homogeneous replicas under the same 72-page budget, 8 slots of 64
    tokens, on `loadgen.mixed_length_trace` (20 requests, seed 0). Checks:
    every request done on both legs, each one's tokens on the
    disaggregated leg bit for bit its tokens on the homogeneous leg,
    program counts flat on both legs, the byte audit (bytes = pages moved
    x ``page_bytes``, 1,179,648 a page), no prefill on the decode
    replica (`disagg.decode_prefill_families`), every engine's page
    ledger after every step, one ``page_migration`` fault falling back
    co-located with no page leak, exact K4 launches, every page back.
    Numbers: migrations, the decode residency ratio (recorded, not
    checked), one page's copy out plus copy in on the card (CUDA events
    over graph replays) against its bound, the chat tier's TTFT. Returns
    (the phase's numbers, K4 launches)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.fault import injection
    from incubator_mxnet_tpu_torch.serve import disagg
    from incubator_mxnet_tpu_torch.telemetry import registry

    loadgen = _loadgen()
    d = DISAGG
    model = base["model"]
    chunks = registry.counter("mx_serve_prefill_chunks_total")
    events = loadgen.mixed_length_trace(
        d["requests"], "gpt", seed=d["seed"], duration_s=d["duration_s"],
        long_frac=d["long_frac"], long_prompt=d["long_prompt"],
        long_jitter=d["long_jitter"], long_new_range=d["long_new_range"],
        chat_prompt_mean=d["chat_prompt_mean"],
        chat_new_range=d["chat_new_range"])
    rng = onp.random.RandomState(d["seed"])
    check_walls = []
    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value
    reps = []

    # leg (a): disaggregated
    gw = _disagg_gateway(serve, model, True)
    reps += _engines(gw)
    _checked_steps(gw, "[disagg] disagg", check_walls)
    m = gw._models["gpt"]
    src, dst = m.replicas[0].slots, m.replicas[1].slots
    _disagg_warm(gw, True, rng)
    p0, b0 = disagg.migration_counts("gpt")
    dis, dis_h = _disagg_leg(gw, True, events)
    p1, b1 = disagg.migration_counts("gpt")
    moved, moved_b = p1 - p0, b1 - b0
    families = disagg.decode_prefill_families(gw, "gpt")
    migrated = sum(h.replica == "gpt#1" for h in dis_h)

    # one page's copy out + copy in on the card: free pages of each side,
    # the engine's own device halves in a graph (time_ms)
    for s in (src, dst):
        s.prefix_cache.evict_unused(1)
    ps, pd = src.allocator.alloc(1), dst.allocator.alloc(1)
    idx_s, idx_d = src._page_index(ps), dst._page_index(pd)
    copy_ms = time_ms(lambda: dst._scatter_pages(
        idx_d, src._gather_pages(idx_s)), [()], MIGRATION_REPS)
    walls = []
    for _ in range(MIGRATION_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_pages_in(pd, src.copy_pages_out(ps))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    src.allocator.decref(ps)
    dst.allocator.decref(pd)
    page_bytes = src.page_bytes
    bound_ms = 2 * page_bytes / PEAK_BYTES_S * 1e3

    # the page_migration fault: co-located on the prefill replica, nothing
    # moved, the decode pool as it was
    free_d = dst.allocator.free_pages
    injection.configure_injection("page_migration:1.0:0:1")
    try:
        e = events[0]
        h = gw.submit("gpt", onp.random.RandomState(e.seed).randint(
            0, VOCAB, (min(e.prompt_len, d["max_len"] - e.max_new - 1),))
            .astype(onp.int32), e.max_new, tenant=e.tenant)
        gw._drive_until([h], timeout=60.0)
        fired = injection.schedule_info()["page_migration"]["fired"]
    finally:
        injection.clear_injection()
    fault_ok = (h.state == "done" and h.replica == "gpt#0" and fired == 1
                and disagg.migration_counts("gpt")[0] == p1
                and dst.allocator.free_pages == free_d
                and h.tokens == dis_h[0].tokens)
    families_after = disagg.decode_prefill_families(gw, "gpt")
    gw.shutdown(drain=True)
    used_a = {rep.label: rep.slots.allocator.used_pages
              for rep in _engines(gw)}
    torch.cuda.empty_cache()

    # leg (b): homogeneous, the same budget
    gw_b = _disagg_gateway(serve, model, False)
    reps += _engines(gw_b)
    _checked_steps(gw_b, "[disagg] homogeneous", check_walls)
    _disagg_warm(gw_b, False, rng)
    homo, homo_h = _disagg_leg(gw_b, False, events)
    gw_b.shutdown(drain=True)
    used_b = {rep.label: rep.slots.allocator.used_pages
              for rep in _engines(gw_b)}
    k4 = read_counts()["K4"]
    n_chunks = chunks.value - chunks0
    want_k4 = _plane_k4("[disagg]", reps, n_chunks, k4)
    same = sum(a.tokens == b.tokens for a, b in zip(dis_h, homo_h))
    ratio = dis["resident_mean"] / max(homo["resident_mean"], 1e-9)
    out = dict(
        model="gpt2_small", dtype="float32", total_pages=d["total_pages"],
        max_slots=d["max_slots"], max_len=d["max_len"],
        requests=len(events), disagg=dis, homogeneous=homo,
        requests_equal=same, migrated_requests=migrated,
        pages_moved=moved, bytes_moved=moved_b, page_bytes=page_bytes,
        decode_residency_ratio=ratio,
        page_copy_device_ms=copy_ms, page_copy_bound_ms=bound_ms,
        page_copy_bound_by="bytes", page_copy_host_wall_ms_median=float(
            onp.median(walls) * 1e3),
        decode_prefill_families=families, fault_fallback_ok=fault_ok,
        page_checks_s=float(sum(check_walls)), prefill_chunks=n_chunks,
        k4_launches_through_wrapper=k4, k4_launches_expected=want_k4,
        pages_used_after_shutdown=dict(used_a, **{
            f"homogeneous {k}": v for k, v in used_b.items()}))
    log(f"[disagg] 1 prefill + 1 decode replica against 2 homogeneous, "
        f"{d['total_pages']} pages: {same} of {len(events)} requests' tokens "
        f"equal across the legs, {migrated} finished on the decode replica "
        f"(the rest co-located on the prefill replica: no decode slot or "
        f"pages free at their hand-off);"
        f" {moved} pages moved, {moved_b} bytes ({page_bytes} a page); "
        f"decode residency {dis['resident_mean']:.3f} against "
        f"{homo['resident_mean']:.3f} a replica: ratio {ratio:.3f} (the "
        f"reference bench's gate 1.5, recorded here, not checked); chat "
        f"TTFT p99 {dis['chat_ttft_p99_ms']:.2f} ms against "
        f"{homo['chat_ttft_p99_ms']:.2f}; tokens/s "
        f"{dis['tokens_per_s']:.1f} against {homo['tokens_per_s']:.1f}")
    log(f"[disagg] one page's copy out + copy in: {copy_ms:.4f} ms of "
        f"device time (graph replays, CUDA events) against the bound "
        f"{bound_ms:.6f} ms (2 x {page_bytes} bytes at 3.35 TB/s), the "
        f"call's host wall {out['page_copy_host_wall_ms_median']:.4f} ms; "
        f"prefill on the decode replica {families}; the page_migration "
        f"fault fell back co-located: {fault_ok}; page checks "
        f"{out['page_checks_s']:.4f} s; K4 through the wrapper {k4} "
        f"(expected {want_k4}); pages in use after shutdown "
        f"{out['pages_used_after_shutdown']}")
    check(same == len(events), f"[disagg]: {len(events) - same} requests' "
          "tokens differ between the legs")
    check(migrated > 0 and moved > 0, "[disagg]: nothing migrated")
    check(page_bytes == PAGE_BYTES_F32, f"[disagg]: {page_bytes} bytes a "
          f"page, expected {PAGE_BYTES_F32}")
    check(moved_b == moved * page_bytes, f"[disagg]: {moved_b} bytes for "
          f"{moved} pages of {page_bytes}")
    check(not families and not families_after,
          f"[disagg]: prefill on the decode replica {families_after}")
    check(fault_ok, "[disagg]: the page_migration fault did not fall back "
          "co-located with the decode pool untouched")
    check(not any(out["pages_used_after_shutdown"].values()),
          f"[disagg]: pages in use {out['pages_used_after_shutdown']}")
    return out, k4


def phase_trace(torch, dev, base):
    """Trace A through a fresh `ServeEngine` (the [serve engine]
    configuration) in turns untraced, traced, traced, untraced, tracing
    on for the trace only: every token the bare engine's; in each traced
    run every request a ``serve.request`` root with its queue, prefill
    and decode spans under it, a ``serve.step`` span for every step and a
    ``serve.decode_step`` for every decode step, and the Chrome export
    valid JSON (written to ``build/serve_trace_a.json``); the decode
    step's host parts (fingerprint, upload, launch) and the scheduler's
    host time a step, traced against untraced; a span's cost on and off.
    Returns (the phase's numbers, K4 launches through the wrapper)."""
    import os

    import numpy as onp

    from incubator_mxnet_tpu_torch.telemetry import registry, tracing

    chunks = registry.counter("mx_serve_prefill_chunks_total")
    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value
    runs, reps, bad, chrome = [], [], [], None
    for traced in (False, True, True, False):
        out, slots, handles, spans = _trace_a_run(torch, base, "engine",
                                                  traced)
        reps.append(SimpleNamespace(slots=slots))
        if traced:
            for h in handles:
                mine = [s for s in spans if s.trace_id == h.trace_id]
                root = [s for s in mine if s.name == "serve.request"]
                if sorted(s.name for s in mine) != [
                        "serve.decode", "serve.prefill", "serve.queue",
                        "serve.request"] or root[0].attrs.get(
                        "tokens") != len(h.tokens) or any(
                        s.parent_id != root[0].span_id for s in mine
                        if s is not root[0]):
                    bad.append(h.id)
            out["serve_step_spans"] = sum(s.name == "serve.step"
                                          for s in spans)
            out["decode_step_spans"] = sum(s.name == "serve.decode_step"
                                           for s in spans)
            check(out["serve_step_spans"] == out["steps"]
                  and out["decode_step_spans"] == out["decode_steps"],
                  "[trace]: a step without its span")
            if chrome is None:
                chrome = json.dumps(tracing.chrome_trace(
                    include_device=True, spans=spans))
        runs.append(out)
        log(f"[trace] {'traced' if traced else 'untraced'}: "
            + _run_text(out))
    events = json.loads(chrome)["traceEvents"]
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "serve_trace_a.json")
    with open(path, "w") as f:
        f.write(chrome)

    def span_us(n=10000):
        t0 = time.perf_counter()
        for i in range(n):
            with tracing.span("serve.step", queued=i, active=i):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    tracing.enable()
    try:
        span_on = span_us()
    finally:
        tracing.disable()
        tracing.reset()
    span_off = span_us()
    k4 = read_counts()["K4"]
    want_k4 = _plane_k4("[trace]", reps, chunks.value - chunks0, k4)

    def med(traced, key, part=None):
        vals = [r[key] if part is None else r[key][part] for r in runs
                if r["traced"] == traced]
        return float(onp.median(vals))

    parts = ("fingerprint", "load_inputs", "replay_launch")
    summary = {name: {"traced": med(True, *k), "untraced": med(False, *k)}
               for name, k in (
                   ("tokens_per_s", ("tokens_per_s",)),
                   ("scheduler_host_ms_a_step",
                    ("scheduler_host_ms_a_step",)),
                   *((p, ("decode_step_host_split_ms", p)) for p in parts))}
    out = dict(order=["traced" if r["traced"] else "untraced" for r in runs],
               runs=runs, medians=summary,
               engine_decode_step_host_split_ms={
                   p: base["host_split"][p] for p in parts},
               requests_with_bad_traces=bad, chrome_events=len(events),
               chrome_bytes=len(chrome), span_us_on=span_on,
               span_us_off=span_off, k4_launches_through_wrapper=k4,
               k4_launches_expected=want_k4)
    log(f"[trace] {2 * len(base['tokens']) - len(bad)} of "
        f"{2 * len(base['tokens'])} traced requests with their four spans "
        f"under one root; the Chrome export {len(events)} events, "
        f"{len(chrome)} bytes of valid JSON ({path})")
    log("[trace] medians traced / untraced (ms): a decode step's host "
        "parts " + ", ".join(
            f"{p} {summary[p]['traced']:.4f} / {summary[p]['untraced']:.4f}"
            f" ([serve engine] {base['host_split'][p]:.4f})" for p in parts)
        + f"; the scheduler's host a step "
        f"{summary['scheduler_host_ms_a_step']['traced']:.4f} / "
        f"{summary['scheduler_host_ms_a_step']['untraced']:.4f}; tokens/s "
        f"{summary['tokens_per_s']['traced']:.1f} / "
        f"{summary['tokens_per_s']['untraced']:.1f}; a serve.step span "
        f"{span_on:.3f} us on, {span_off:.3f} us off; K4 through the "
        f"wrapper {k4} (expected {want_k4})")
    check(not bad, f"[trace]: requests {bad[:8]} lack a complete trace")
    return out, k4


def phase_fault(torch, dev, base):
    """One ``serve_step`` fault armed through ``MXNET_FAULT_INJECT`` (read
    by `util._apply_env_config`, as at the package's import) on a live
    engine on the card with tracing on: the step raises `FaultInjected`,
    the flight dump (``MXNET_FLIGHTREC_DIR`` under ``build/``) exists and
    holds the requests' open spans and the fired schedule, the next steps
    serve every request with the bare engine's tokens, and every page
    comes back. Returns (the phase's numbers, K4 launches)."""
    import glob
    import os

    import numpy as onp

    from incubator_mxnet_tpu_torch import fault, serve, util
    from incubator_mxnet_tpu_torch.telemetry import tracing

    dump_dir = os.path.abspath(os.path.join("build", "flightrec"))
    os.makedirs(dump_dir, exist_ok=True)
    for old in glob.glob(os.path.join(dump_dir, "flightrec_*.json")):
        os.remove(old)
    prompts = _serve_trace_a(onp)[0][:FAULT_REQUESTS]
    engine = serve.ServeEngine(base["model"], max_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    reset_counts()
    env = {"MXNET_FAULT_INJECT": "serve_step:1.0:0:1",
           "MXNET_FLIGHTREC_DIR": dump_dir}
    saved = {k: os.environ.get(k) for k in env}
    tracing.enable()
    try:
        handles = [engine.submit(p, FAULT_NEW) for p in prompts]
        engine.step()                      # admitted, prefilled
        held = engine._sched.slots.allocator.used_pages
        os.environ.update(env)
        util._apply_env_config()
        armed = fault.injection_enabled("serve_step")
        raised = None
        try:
            engine.step()
        except fault.FaultInjected as e:
            raised = e
        fired = fault.schedule_info()["serve_step"]["fired"]
        dumps = glob.glob(os.path.join(dump_dir,
                                       "flightrec_serve_step_*.json"))
        payload = json.loads(open(dumps[0]).read()) if dumps else {}
        open_ids = {s["attrs"].get("request")
                    for s in payload.get("open_spans", [])
                    if s["name"] == "serve.request"}
        engine._drive_until(handles)
    finally:
        fault.clear_injection()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tracing.disable()
        tracing.reset()
    k4 = read_counts()["K4"]
    engine.shutdown(drain=True)
    used = engine._sched.slots.allocator.used_pages
    same = all(h.tokens == base["tokens"][i][:FAULT_NEW]
               for i, h in enumerate(handles))
    out = dict(requests=len(handles), armed=armed,
               raised=type(raised).__name__ if raised else None,
               fired=fired, dumps=len(dumps),
               dump_error=payload.get("error"),
               open_request_spans=sorted(i for i in open_ids
                                         if i is not None),
               pages_held_at_fault=held, tokens_equal_to_engine=same,
               k4_launches_through_wrapper=k4,
               pages_used_after_shutdown=used)
    log(f"[fault] MXNET_FAULT_INJECT=serve_step:1.0:0:1 on a live engine "
        f"({len(handles)} requests holding {held} pages): armed {armed}, "
        f"the step raised {out['raised']} (fired {fired}); flight dumps "
        f"{len(dumps)}, its open serve.request spans "
        f"{out['open_request_spans']}; then every request served with the "
        f"bare engine's tokens: {same}; K4 through the wrapper {k4}; pages "
        f"in use after shutdown {used}")
    check(armed and raised is not None and fired == 1,
          "[fault]: the serve_step fault did not fire from the step")
    check(len(dumps) == 1 and payload["error"]["type"] == "FaultInjected",
          f"[fault]: {len(dumps)} flight dumps")
    check(open_ids >= {h.id for h in handles},
          "[fault]: the dump lacks the requests' open spans")
    check(payload["fault_schedule"]["serve_step"]["fired"] == 1,
          "[fault]: the dump lacks the fired schedule")
    check(same, "[fault]: tokens after the fault differ from the engine's")
    check(k4 > 0, "[fault]: K4 was not launched on the path")
    check(used == 0, f"[fault]: {used} pages in use after shutdown")
    return out, k4


def _elastic_gateway(serve, model, replicas):
    e = ELASTIC
    reg = serve.ModelRegistry(total_pages=e["pages_a_replica"]
                              * e["max_replicas"])
    reg.add("gpt", model, max_slots=e["max_slots"], max_len=e["max_len"],
            replicas=replicas)
    return serve.Gateway(reg, tenants={"acme": {"weight": 2.0},
                                       "beta": {"weight": 1.0}})


def _elastic_warm(rep, rng):
    """bench.py's `warm_all` for one replica (its scheduler driven
    directly, out of the routing set): one request of each warm length,
    so every chunk bucket runs once and the decode graph is captured."""
    import numpy as onp

    for n in ELASTIC["warm_lens"]:
        seg = rep.sched.submit(
            rng.randint(0, VOCAB, (n,)).astype(onp.int32), 2)
        while not seg.done:
            rep.sched.step()


def _collect_handles(gw):
    """Keep every handle `gw.submit` returns (`loadgen.replay` keeps
    none), in submission order."""
    handles = []
    submit = gw.submit

    def keep(*args, **kwargs):
        h = submit(*args, **kwargs)
        handles.append(h)
        return h

    gw.submit = keep
    return handles


def _family_entries(compiles, label):
    """Program-ledger entries of one replica (its ``serve:<label>.*``
    families)."""
    prefix = f"serve:{label}."
    return sum(len(v) for k, v in compiles.ledger().items()
               if k.startswith(prefix))


def _census_text(census, labels):
    own = census["owners"]
    return (f"total {census['total']} B, kv_pool "
            + ", ".join(f"{lb} {own.get(f'serve:{lb}.kv_pool', 0)}"
                        for lb in labels)
            + f", params {sum(v for k, v in own.items() if k.endswith('.params'))}"
            f", unattributed {census['unattributed']}")


class _ElasticWatch:
    """Hooks on a `ReplicaSetController` for `phase_elastic`: every spawn
    and every release (retire or death) with the card's allocated bytes
    and the census before and after (its kv_pool bytes checked against
    the live replicas' pools after each), each spawned replica's ledger
    entries at publication, and every engine the leg ever had (the K4
    count). A release must give back the bytes its replica took at its
    spawn (within `ELASTIC_MEM_TOL`), and where no other replica joined or
    left in between, bring the card back to its level before the spawn."""

    def __init__(self, torch, dev, ctl, hbm, compiles, engines, what):
        self.torch, self.dev, self.hbm, self.compiles = torch, dev, hbm, \
            compiles
        self.what, self.engines = what, engines
        self.spawns, self.releases, self.events = {}, [], []
        self.published = {}
        spawn, release = ctl._spawn, ctl._release

        def spawn_(m, now, reason, role=None):
            before = self._mem()
            cen = hbm.census(top_k=0)
            rep = spawn(m, now, reason, role=role)
            after = self._mem()
            self.spawns[rep.label] = dict(
                before=before, after=after, seq=len(self.events),
                warm_s=ctl.warm_seconds.get(rep.label),
                captures=rep.slots.captures,
                programs=ctl.warm_programs.get(rep.label))
            self.published[rep.label] = _family_entries(compiles,
                                                         rep.label)
            self.events.append(("spawn", rep.label))
            engines.append(rep)
            _kv_census_check(hbm, ctl._gw, f"{what} after spawning "
                             f"{rep.label}")
            labels = [r.label for r in m.replicas]
            log(f"{what} spawn {rep.label} ({reason}): allocated {before} ->"
                f" {after} B; census before: {_census_text(cen, labels)};"
                f" after: {_census_text(hbm.census(top_k=0), labels)}")
            return rep

        def release_(rep):
            before = self._mem()
            cen = hbm.census(top_k=0)
            release(rep)
            after = self._mem()
            sp = self.spawns.get(rep.label)
            row = dict(label=rep.label, before=before, after=after,
                       freed=before - after,
                       programs=rep.slots.xla_program_count(),
                       ledger=_family_entries(compiles, rep.label))
            if sp is not None:
                row["programs_at_publication"] = sp["programs"]
                row["ledger_at_publication"] = self.published[rep.label]
                row["took"] = sp["after"] - sp["before"]
                row["lifo"] = self.events[sp["seq"] + 1:] == []
                row["vs_before_spawn"] = after - sp["before"]
            self.releases.append(row)
            self.events.append(("release", rep.label))
            _kv_census_check(hbm, ctl._gw, f"{what} after releasing "
                             f"{rep.label}")
            log(f"{what} release {rep.label}: allocated {before} -> "
                f"{after} B ({row}); census before: "
                f"{_census_text(cen, [rep.label])}; after: "
                f"{_census_text(hbm.census(top_k=0), [rep.label])}")

        ctl._spawn, ctl._release = spawn_, release_

    def _mem(self):
        self.torch.cuda.synchronize(self.dev)
        return int(self.torch.cuda.memory_allocated(self.dev))

    def check(self):
        for row in self.releases:
            if "took" not in row:
                continue
            check(row["programs"] == row["programs_at_publication"]
                  and row["ledger"] == row["ledger_at_publication"],
                  f"{self.what} {row['label']}: programs "
                  f"{row['programs_at_publication']} at publication, "
                  f"{row['programs']} at its release (ledger entries "
                  f"{row['ledger_at_publication']} -> {row['ledger']})")
            check(abs(row["freed"] - row["took"]) <= ELASTIC_MEM_TOL,
                  f"{self.what} {row['label']}: its release freed "
                  f"{row['freed']} B, its spawn took {row['took']} B")
            if row["lifo"]:
                check(abs(row["vs_before_spawn"]) <= ELASTIC_MEM_TOL,
                      f"{self.what} {row['label']}: allocated bytes "
                      f"{row['vs_before_spawn']} B off their level before "
                      "its spawn after its release")


def _spawn_report(compiles, watch):
    """Each spawn of a leg: its warmup wall on the step thread, its
    captures and prefill buckets with their seconds from the program
    ledger (reset at the leg's start), its allocated bytes around it."""
    out = {}
    led = compiles.ledger()
    for lb, sp in watch.spawns.items():
        entries = [dict(family=f, seconds=x["seconds"], bucket=x["bucket"],
                        cause=x["cause"])
                   for f, es in led.items() if f.startswith(f"serve:{lb}.")
                   for x in es]
        built = sum(x["seconds"] for x in entries)
        out[lb] = dict(warm_s=sp["warm_s"], captures=sp["captures"],
                       allocated_before=sp["before"],
                       allocated_after=sp["after"], ledger=entries,
                       outside_ledger_s=sp["warm_s"] - built)
        log(f"{watch.what} spawn {lb}: warmup {sp['warm_s']:.4f} s on the "
            f"step thread ({sp['warm_s'] - built:.4f} s outside the "
            f"programs it built), {sp['captures']} capture(s) "
            + ", ".join(f"{x['family']} {x['seconds']:.4f} s"
                        for x in entries
                        if not x["family"].endswith("prefill"))
            + "; prefill buckets "
            + ", ".join(f"{x['bucket']} {x['seconds']:.4f} s"
                        for x in entries if x["family"].endswith("prefill")))
    return out


def _kv_census_check(hbm, gw, what):
    """The census's kv_pool owners equal the live replicas' cache bytes
    exactly (released replicas drop out)."""
    live = sum(r.slots.cache_bytes for r in gw._models["gpt"].replicas)
    own = hbm.census(top_k=0)["owners"]
    kv = sum(v for k, v in own.items()
             if k.startswith("serve:gpt") and k.endswith(".kv_pool"))
    check(kv == live, f"{what}: census kv_pool {kv} B, the live replicas' "
          f"cache_bytes {live} B")
    return kv


def _sched_host_ms(torch, serve, model, events, interval):
    """The scheduler's host ms a step on `ELASTIC["sampler_requests"]`
    requests of the trace, all submitted at once to a fresh one-replica
    gateway and stepped to the end, with the timeseries sampler at
    ``interval`` seconds (None: disarmed): each engine step's wall minus
    its decode steps and prefill chunks, over the steps."""
    import numpy as onp

    from incubator_mxnet_tpu_torch.telemetry import timeseries as ts

    gw = _elastic_gateway(serve, model, 1)
    rep = gw._models["gpt"].replicas[0]
    _elastic_warm(rep, onp.random.RandomState(1))
    walls = {n: [] for n in ("engine", "decode", "prefill")}
    rep.sched.step = _timed(rep.sched.step, walls["engine"])
    rep.slots.decode_step = _timed(rep.slots.decode_step, walls["decode"])
    rep.slots.prefill_chunk_step = _timed(rep.slots.prefill_chunk_step,
                                          walls["prefill"])
    torch.cuda.synchronize()
    for w in walls.values():
        del w[:]
    ts.reset()
    if interval is not None:
        ts.enable(interval_s=interval, samples=ELASTIC["ts_samples"])
    try:
        hs = [gw.submit("gpt", onp.random.RandomState(e.seed).randint(
            0, VOCAB, (e.prompt_len,)).astype(onp.int32), e.max_new)
            for e in events[:ELASTIC["sampler_requests"]]]
        gw._drive_until(hs, timeout=120.0)
        ticks = ts.sample_count()
    finally:
        ts.disable()
        ts.reset()
    gw.shutdown(drain=False)
    n = len(walls["engine"])
    host = (sum(walls["engine"]) - sum(walls["decode"])
            - sum(walls["prefill"])) / n * 1e3
    return host, n, ticks, [h.tokens for h in hs], rep


def phase_elastic(torch, dev, base):
    """The shape of the reference's `bench_gpt_serve_elastic`
    (bench.py:1019-1178) at full width: gpt2_small (f32, the model of
    `phase_serve_engine`) behind a `serve.Gateway` with the autoscale
    advisor and the elastic replica controller, on the seeded diurnal day
    of `loadgen.diurnal_trace` (`ELASTIC`). Leg (a): live from one
    replica, the timeseries sampler (0.25 s) and the device-memory census
    armed, the advisor every 0.5 s, the controller spawning (warmed on the
    step thread before publication) and draining replicas; then idle steps
    until a drain retires a replica or `ELASTIC["tail_s"]` passes. Leg
    (b): static at two replicas. Leg (c): the first
    `ELASTIC["crash_requests"]` requests of the day at once on two
    replicas (one spawned by the controller), ``MXNET_FAULT_INJECT`` set
    to ``replica_crash@1`` after `ELASTIC["crash_at"]` submissions (read
    through `util._apply_env_config`): the dead replica is released, its
    requests re-queued and a replacement spawned. Then the scheduler's
    host ms a step with the sampler off, at 0.25 s and at 0.01 s, in
    turns (each a fresh one-replica gateway, its tokens the same). Checks
    (each raises): no failed request on any leg, at least
    one scale event in (a), no program built on a live replica after it
    joined the routing set (its program count equals its count at
    publication, and the program ledger has no entry of its families
    since), the high tier's ``slo.gateway_ttft`` (20 s, target 0.6),
    the chips-hours ratio in (0, 1), every request's tokens equal in (a)
    and (b), the dead replica replaced and its requests finished in (c),
    a released replica's bytes back (`_ElasticWatch`), the census's
    kv_pool bytes equal to the live replicas' cache bytes, the page
    ledger after every step, exact K4 launches. Returns (the phase's
    numbers, K4 launches)."""
    import gc
    import os

    import numpy as onp

    from incubator_mxnet_tpu_torch import serve, util
    from incubator_mxnet_tpu_torch.fault import injection
    from incubator_mxnet_tpu_torch.serve.advisor import AutoscaleAdvisor
    from incubator_mxnet_tpu_torch.telemetry import compiles, hbm, registry
    from incubator_mxnet_tpu_torch.telemetry import slo
    from incubator_mxnet_tpu_torch.telemetry import timeseries as ts

    loadgen = _loadgen()
    e = ELASTIC
    model = base["model"]
    gc.collect()
    events, segments = loadgen.diurnal_trace(
        models={"gpt": 1.0},
        tenants={"acme": (2.0, "high"), "beta": (1.0, "normal")},
        seed=e["seed"], trough_s=e["trough"][0], steady_s=e["steady"][0],
        surge_s=e["surge"][0], burst_s=e["burst"][0],
        trough_rate=e["trough"][1], steady_rate=e["steady"][1],
        surge_rate=e["surge"][1], burst_rate=e["burst"][1],
        prompt_mean=e["prompt_mean"], prompt_max=e["prompt_max"],
        max_new_range=e["max_new_range"])
    rng = onp.random.RandomState(e["seed"])
    chunks = registry.counter("mx_serve_prefill_chunks_total")
    check_walls = []
    engines = []
    compiles.reset()
    compiles.enable()
    hbm.reset()
    hbm.enable()
    torch.cuda.synchronize()
    reset_counts()
    chunks0 = chunks.value

    # -- leg (a): live from one replica -------------------------------
    gw = _elastic_gateway(serve, model, 1)
    engines += _engines(gw)
    ts.reset()
    ts.enable(interval_s=e["ts_interval"], samples=e["ts_samples"])
    gw._advisor_period = e["advisor_period"]
    gw._advisor_next_t = None
    gw._advisors = {"gpt": AutoscaleAdvisor("gpt", **e["advisor"])}
    ctl = gw.enable_elastic(min_replicas=1, max_replicas=e["max_replicas"],
                            warm_lens=e["warm_lens"], warm_new=2)
    watch = _ElasticWatch(torch, dev, ctl, hbm, compiles, engines,
                          "[elastic] (a)")
    for rep in gw._models["gpt"].replicas:
        _elastic_warm(rep, rng)
    base_programs = {r.label: r.slots.xla_program_count()
                     for r in gw._models["gpt"].replicas}
    published = {r.label: _family_entries(compiles, r.label)
                 for r in gw._models["gpt"].replicas}
    obj = slo.gateway_ttft("high", threshold_s=e["ttft_slo"][0],
                           target=e["ttft_slo"][1], name="elastic_live_high")
    _checked_steps(gw, "[elastic] (a)", check_walls)
    live_h = _collect_handles(gw)
    try:
        t0 = time.monotonic()
        live = loadgen.replay(gw, events, VOCAB, timeout=300.0)
        t1 = time.monotonic()
        for _ in range(8):
            gw.step()                    # retire finished drains
        journal_trace = ctl.scale_log()
        programs = {}
        for rep in gw._models["gpt"].replicas:
            want = ctl.warm_programs.get(rep.label,
                                         base_programs.get(rep.label))
            pub = watch.published.get(rep.label, published.get(rep.label))
            programs[rep.label] = dict(
                at_publication=want, now=rep.slots.xla_program_count(),
                ledger_at_publication=pub,
                ledger_now=_family_entries(compiles, rep.label))
        # idle tail: the advisor's slow window empties, a drain retires a
        # replica (its memory comes back) or the tail ends
        t_tail = time.monotonic()
        while time.monotonic() - t_tail < e["tail_s"] and not any(
                ev["direction"] == "down" for ev in ctl.scale_log()):
            if not gw.step():
                time.sleep(0.005)
        tail_s = time.monotonic() - t_tail
        journal = ctl.scale_log()
        res = obj.evaluate()
        kv_a = _kv_census_check(hbm, gw, "[elastic] (a)")
        advice = gw.advisor_log()
        ticks = ts.sample_count()
    finally:
        slo.tracker().remove("elastic_live_high")
        ts.disable()
        ts.reset()
        gw.shutdown(drain=False)
    check(not live["failed"], f"[elastic] (a): {len(live['failed'])} "
          f"requests failed, first {live['failed'][:1]}")
    check(journal_trace, "[elastic] (a): no scale event across the day "
          "(the advisor loop never closed)")
    for label, p in programs.items():
        check(p["at_publication"] is not None
              and p["now"] == p["at_publication"],
              f"[elastic] (a) {label}: program count {p['at_publication']}"
              f" at publication, {p['now']} now")
        check(p["ledger_now"] == p["ledger_at_publication"],
              f"[elastic] (a) {label}: {p['ledger_now']} ledger entries, "
              f"{p['ledger_at_publication']} at publication")
    check(res["ok"], f"[elastic] (a): the high tier's TTFT SLO {res}")
    chip_s, n_prev, t_prev = 0.0, 1, t0
    for ev in journal_trace:
        t = min(max(ev["t"], t0), t1)
        chip_s += n_prev * (t - t_prev)
        n_prev, t_prev = ev["n"], t
    chip_s += n_prev * (t1 - t_prev)
    live_wall = t1 - t0
    ratio = (chip_s / live_wall) / float(e["max_replicas"])
    check(0.0 < ratio < 1.0, f"[elastic]: chips-hours ratio {ratio}")
    high = [h.ttft for h in live_h if h.priority == "high"
            and h.ttft is not None]
    tok_a = sum(len(h.tokens) for h in live_h)
    spawns = {"a": _spawn_report(compiles, watch)}
    log(f"[elastic] (a) scale journal: "
        + "; ".join(f"{ev['t'] - t0:+.3f} s {ev['direction']} "
                    f"{ev['replica']} -> {ev['n']} ({ev['reason'][:60]})"
                    for ev in journal))
    watch.check()

    # -- leg (b): static at the peak -----------------------------------
    compiles.reset()
    gw_b = _elastic_gateway(serve, model, e["max_replicas"])
    engines += _engines(gw_b)
    for rep in gw_b._models["gpt"].replicas:
        _elastic_warm(rep, rng)
    programs_b0 = gw_b.xla_program_counts(per_replica=True)
    _checked_steps(gw_b, "[elastic] (b)", check_walls)
    static_h = _collect_handles(gw_b)
    try:
        static = loadgen.replay(gw_b, events, VOCAB, timeout=300.0)
        programs_b1 = gw_b.xla_program_counts(per_replica=True)
    finally:
        gw_b.shutdown(drain=False)
    check(not static["failed"], f"[elastic] (b): {len(static['failed'])} "
          "requests failed")
    check(programs_b1 == programs_b0, f"[elastic] (b): program counts "
          f"{programs_b0} -> {programs_b1}")
    tok_b = sum(len(h.tokens) for h in static_h)
    same = sum(a.tokens == b.tokens for a, b in zip(live_h, static_h))
    differ = [(a.id, a.preemptions, b.preemptions)
              for a, b in zip(live_h, static_h) if a.tokens != b.tokens]

    # -- leg (c): a replica dies mid-trace -------------------------------
    compiles.reset()
    gw_c = _elastic_gateway(serve, model, 1)
    engines += _engines(gw_c)
    ctl_c = gw_c.enable_elastic(min_replicas=1,
                                max_replicas=e["max_replicas"],
                                warm_lens=e["warm_lens"], warm_new=2)
    watch_c = _ElasticWatch(torch, dev, ctl_c, hbm, compiles, engines,
                            "[elastic] (c)")
    for rep in gw_c._models["gpt"].replicas:
        _elastic_warm(rep, rng)
    ctl_c.scale_up("gpt")                # gpt#1, the one that dies
    _checked_steps(gw_c, "[elastic] (c)", check_walls)
    crash_events = sorted(events, key=lambda ev: ev.t)[:e["crash_requests"]]
    saved = os.environ.get("MXNET_FAULT_INJECT")
    crash_h = []
    try:
        t0c = time.monotonic()
        for i, ev in enumerate(crash_events):
            crash_h.append(gw_c.submit(
                "gpt", onp.random.RandomState(ev.seed).randint(
                    0, VOCAB, (ev.prompt_len,)).astype(onp.int32),
                ev.max_new, tenant=ev.tenant, priority=ev.priority))
            gw_c.step()
            if i + 1 == e["crash_at"]:
                os.environ["MXNET_FAULT_INJECT"] = "replica_crash@1:1.0:0:1"
                util._apply_env_config()
        gw_c._drive_until(crash_h, timeout=120.0)
        wall_c = time.monotonic() - t0c
        fired = injection.schedule_info()["replica_crash"]["fired"]
        journal_c = ctl_c.scale_log()
        kv_c = _kv_census_check(hbm, gw_c, "[elastic] (c)")
        labels_c = [r.label for r in gw_c._models["gpt"].replicas]
    finally:
        injection.clear_injection()
        if saved is None:
            os.environ.pop("MXNET_FAULT_INJECT", None)
        else:
            os.environ["MXNET_FAULT_INJECT"] = saved
        gw_c.shutdown(drain=False)
    replaced = [ev for ev in journal_c if ev["direction"] == "replace"]
    requeued = int(replaced[0]["reason"].split("requeued ")[1].split()[0]) \
        if replaced else 0
    check(fired == 1 and len(replaced) == 1
          and replaced[0]["replica"] == "gpt#1",
          f"[elastic] (c): the crash did not fire on gpt#1: {journal_c}")
    check("gpt#1" not in labels_c and len(labels_c) == e["max_replicas"],
          f"[elastic] (c): replicas after the crash {labels_c}")
    check(all(h.state == "done" for h in crash_h),
          f"[elastic] (c): {[h.state for h in crash_h]}")
    watch_c.check()
    spawns["c"] = _spawn_report(compiles, watch_c)
    # the day's first requests, in order: leg (b) served the same ones
    crash_same = sum(h.tokens == b.tokens for h, b in zip(crash_h, static_h))

    # -- the sampler's cost: the scheduler's host ms a step, in turns ------
    host = []
    for interval in (None, e["ts_interval"], 0.01, 0.01, e["ts_interval"],
                     None):
        ms, steps, ticks_s, toks, rep = _sched_host_ms(
            torch, serve, model, events, interval)
        engines.append(rep)
        host.append(dict(interval_s=interval, host_ms_a_step=ms,
                         steps=steps, sampler_ticks=ticks_s))
        if len(host) == 1:
            ref_toks = toks
        check(toks == ref_toks, "[elastic] sampler turns: tokens moved "
              f"with the sampler at {interval}")
    compiles.disable()
    hbm.disable()

    k4 = read_counts()["K4"]
    n_chunks = chunks.value - chunks0
    want_k4 = _plane_k4("[elastic]", engines, n_chunks, k4)
    out = dict(
        model="gpt2_small", dtype="float32", max_slots=e["max_slots"],
        max_len=e["max_len"], pages_a_replica=e["pages_a_replica"],
        max_replicas=e["max_replicas"], requests=len(events),
        segments=[list(sg) for sg in segments],
        live=dict(wall_s=live["wall_s"], tokens=tok_a,
                  tokens_per_s=tok_a / live["wall_s"],
                  completed=live["completed"],
                  preemptions=live["preemptions"],
                  scale_events=len(journal_trace),
                  scale_ups=sum(ev["direction"] == "up"
                                for ev in journal_trace),
                  scale_downs=sum(ev["direction"] == "down"
                                  for ev in journal_trace),
                  tail_s=tail_s, tail_downs=sum(
                      ev["direction"] == "down" for ev in journal)
                  - sum(ev["direction"] == "down" for ev in journal_trace),
                  journal=[dict(ev, t=ev["t"] - t0) for ev in journal],
                  chips_hours_ratio=ratio,
                  mean_live_replicas=chip_s / live_wall,
                  high_ttft_p50_s=_pct(high, 50),
                  high_ttft_p99_s=_pct(high, 99),
                  high_ttft_compliance=res["compliance"],
                  advisor_decisions=len(advice),
                  advisor_actions=sorted({r["action"] for r in advice}),
                  sampler_ticks=ticks, programs=programs,
                  kv_pool_census_bytes=kv_a),
        static=dict(wall_s=static["wall_s"], tokens=tok_b,
                    tokens_per_s=tok_b / static["wall_s"],
                    completed=static["completed"],
                    preemptions=static["preemptions"],
                    program_counts=programs_b1),
        requests_equal=same, requests_differing=differ,
        crash=dict(requests=len(crash_h), wall_s=wall_c,
                   tokens_per_s=sum(len(h.tokens) for h in crash_h)
                   / wall_c, requeued=requeued,
                   journal=[dict(ev, t=ev["t"] - t0c) for ev in journal_c],
                   replicas_after=labels_c, kv_pool_census_bytes=kv_c,
                   tokens_equal_to_static=crash_same),
        spawns=spawns, releases=watch.releases + watch_c.releases,
        sampler_host_ms=host, page_checks_s=float(sum(check_walls)),
        prefill_chunks=n_chunks, k4_launches_through_wrapper=k4,
        k4_launches_expected=want_k4)
    log(f"[elastic] (a) live from 1 replica: {live['completed']} requests in"
        f" {live['wall_s']:.3f} s, {out['live']['tokens_per_s']:.1f} "
        f"tokens/s; {len(journal_trace)} scale events in the day "
        f"({out['live']['scale_ups']} up, {out['live']['scale_downs']} "
        f"down), {out['live']['tail_downs']} down in the {tail_s:.2f} s "
        f"tail; mean live replicas {chip_s / live_wall:.3f}, chips-hours "
        f"ratio {ratio:.4f}; high-tier TTFT p50 {_pct(high, 50):.4f} s p99 "
        f"{_pct(high, 99):.4f} s, compliance {res['compliance']:.4f} "
        f"(gate 20 s at 0.6); preemptions {live['preemptions']}; "
        f"{len(advice)} advisor decisions {out['live']['advisor_actions']};"
        f" {ticks} sampler ticks; programs {programs}")
    log(f"[elastic] (b) static at {e['max_replicas']}: {static['completed']}"
        f" requests in {static['wall_s']:.3f} s, "
        f"{out['static']['tokens_per_s']:.1f} tokens/s; {same} of "
        f"{len(live_h)} requests' tokens equal to leg (a)'s")
    log(f"[elastic] (c) replica_crash@1 after {e['crash_at']} of "
        f"{len(crash_h)} requests: journal "
        + "; ".join(f"{ev['direction']} {ev['replica']} -> {ev['n']}"
                    for ev in journal_c)
        + f"; {requeued} requests re-queued, all {len(crash_h)} done in "
        f"{wall_c:.3f} s ({out['crash']['tokens_per_s']:.1f} tokens/s), "
        f"{crash_same} with leg (b)'s tokens; replicas {labels_c}")
    log("[elastic] scheduler host ms a step (sampler off / 0.25 s / "
        "0.01 s, in turns): " + ", ".join(
            f"{h['interval_s']}: {h['host_ms_a_step']:.4f} "
            f"({h['steps']} steps, {h['sampler_ticks']} ticks)"
            for h in host))
    log(f"[elastic] releases {out['releases']}; page checks "
        f"{out['page_checks_s']:.4f} s; K4 through the wrapper {k4} "
        f"(expected {want_k4})")
    check(same == len(live_h) == len(static_h),
          f"[elastic]: {len(live_h) - same} requests' tokens differ "
          f"between legs (a) and (b): (id, preemptions a, b) {differ[:8]}")
    check(any(r.get("took") is not None for r in out["releases"]),
          "[elastic]: no spawned replica was released: the memory check "
          "did not run")
    return out, k4


def phase_times(torch, attn, lns):
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    for c in attn:
        kw = dict(lengths=c["lengths"], causal=c["causal"],
                  layout=c["layout"])
        mask = None
        if c["lengths"] is not None:
            mask = (torch.arange(c["t"], device=c["base"].device)[None, :]
                    < c["lengths"][:, None])[:, None, None, :]

        def lib(base, c=c, mask=mask):
            q, k, v = split_qkv(c, base)
            if c["layout"] == "bthd":
                q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           is_causal=c["causal"])

        def run(base, impl, c=c, kw=kw):
            fa.flash_attention(*split_qkv(c, base), impl=impl, **kw)

        sets = input_sets([c["base"]], 20)
        c["ms"] = time_ms(lambda b: run(b, "kernel"), sets, 20)
        c["plain_ms"] = time_ms(lambda b: run(b, "plain"), sets, 5)
        c["library_ms"] = time_ms(lib, sets, 20)
        n, t, dt = c["n"], c["t"], _dt(c["dtype"])
        item = c["base"].element_size()
        if c["lengths"] is None:
            flops = 4 * n * H * t * t * D / (2 if c["causal"] else 1)
        else:  # rows and keys past each length are not needed
            flops = 4 * H * D * float((c["lengths"].double() ** 2).sum())
        # q, k, v read where live; o and lse written in full
        live = live_share(c["lengths"], t)
        c["bound_ms"], c["bound_by"] = bound(
            (3 * live + 1) * n * H * t * D * item + n * H * t * 4, flops, dt,
            tensor_cores=True)
        log(f"[time] K1 N={n} T={t} {dt} causal={c['causal']} "
            f"lengths={c['lengths'] is not None}: "
            f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
            f"sdpa {c['library_ms']:.4f} ms (kernel/sdpa "
            f"{c['ms'] / c['library_ms']:.2f}), bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), roofline share "
            f"{c['bound_ms'] / c['ms']:.3f}")
    sms = ln.sm_count(lns[0]["x"].device)
    for c in lns:
        x, gm, bt = c["x"], c["gamma"], c["beta"]
        lib, c["library"] = layer_norm_library(torch, x, gm, bt)
        sets = input_sets([x], 50)  # outputs kept: y too cycles
        warm = time_ms(lambda x: ln.layer_norm_fwd(x, gm, bt, impl="kernel"),
                       sets, 50, keep=True)
        c["plain_ms"] = time_ms(lambda x: ln.layer_norm_fwd(
            x, gm, bt, impl="plain"), sets, 20, keep=True)
        lib_warm = time_ms(lambda x: lib(x, gm, bt), sets, 50, keep=True)
        rows, ix, ip = c["rows"], x.element_size(), gm.element_size()
        c["blocks"] = ln.row_blocks(rows, sms)
        extra = ""
        if rows <= COLD_LN_ROWS:  # gamma and beta cold too, as in a replay
            cold = cold_sets([x, gm, bt])
            c["ms"] = time_ms(lambda x, g, b: ln.layer_norm_fwd(
                x, g, b, impl="kernel"), cold, len(cold))
            c["library_ms"] = time_ms(lib, cold, len(cold))
            c["floor_ms"] = time_ms(empty_launch(
                torch, c["blocks"], 32 * ln.ROW_WARPS), cold, len(cold))
            c["warm_ms"], c["library_warm_ms"] = warm, lib_warm
            extra = (f" (x, gamma and beta cold; warm {warm:.4f} ms, "
                     f"{c['library']} warm {lib_warm:.4f} ms), launch floor "
                     f"{c['floor_ms']:.4f} ms (an empty kernel on the same "
                     f"grid)")
        else:
            c["ms"], c["library_ms"] = warm, lib_warm
        c["bound_ms"], c["bound_by"] = bound(
            2 * rows * C * ix + 8 * rows + 2 * C * ip, 8 * rows * C,
            _ops_dtype(c))
        log(f"[time] K4 ({rows}, {C}) {c['layout']} "
            f"{c['blocks']} blocks: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, {c['library']} {c['library_ms']:.4f} "
            f"ms{extra}, bound {c['bound_ms']:.4f} ms ({c['bound_by']}), "
            f"roofline share {c['bound_ms'] / c['ms']:.3f}")
    x8 = next(c for c in lns if c["rows"] == N and c["layout"] == "f32")
    host = wrapper_host_us(torch, lambda: ln.layer_norm_fwd(
        x8["x"], x8["gamma"], x8["beta"]))
    x8["host_us_a_call"] = host
    log(f"[time] K4 wrapper ({N}, {C}) f32: {host:.2f} us of host time a "
        f"call (layer_norm_fwd, least of 7 x {HOST_CALLS} calls)")


# calls a host-time batch makes (the card runs each in a few us, so the
# host never waits on it)
HOST_CALLS = 1000


def wrapper_host_us(torch, fn):
    """Host us of one call of ``fn``: the least over 7 batches of
    HOST_CALLS calls with no synchronisation between them (the host is
    shared, so other work only adds to a batch)."""
    fn()
    torch.cuda.synchronize()
    batches = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        batches.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return min(batches)


# an empty kernel, the launch floor timed beside K4 at a few rows: built
# by `phase_build` beside the port's kernels, and no part of them
EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int mx_empty_kernel(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""
_EMPTY_LIB, _EMPTY_LIB_PATH = [], []


def _start_empty_kernel_build():
    """Start nvcc on EMPTY_KERNEL_CU (into the git-ignored build/): the
    library's path and the running process."""
    from incubator_mxnet_tpu_torch.ops import _build

    d = _build.BUILD_DIR.parent / "launch_floor"
    d.mkdir(parents=True, exist_ok=True)
    (d / "empty_kernel.cu").write_text(EMPTY_KERNEL_CU)
    lib = d / "empty_kernel.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(d / "empty_kernel.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def empty_launch(torch, blocks, threads):
    """A function that launches an empty kernel on ``blocks`` blocks of
    ``threads`` threads (the launch floor of a kernel on that grid)."""
    import ctypes

    if not _EMPTY_LIB:
        lib = ctypes.CDLL(str(_EMPTY_LIB_PATH[0]))
        lib.mx_empty_kernel.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.mx_empty_kernel.restype = ctypes.c_int
        _EMPTY_LIB.append(lib)
    lib = _EMPTY_LIB[0]

    def fn(*_):
        err = lib.mx_empty_kernel(blocks, threads,
                                  torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"empty kernel: CUDA error {err}")
    return fn


def _ops_dtype(c):
    """The dtype whose peak rate bounds a row kernel case's operations:
    its own, or float32 for a mixed layout (its arithmetic is f32)."""
    return _dt(c["dtype"]) if c["layout"] in ("f32", "bf16") else "float32"


def layer_norm_library(torch, x, gamma, beta):
    """(fn(x, gamma, beta), its name): one PyTorch call computing the
    LayerNorm kernels' function on these dtypes, ``F.layer_norm``; where
    it does not take the mix (bf16 x with f32 gamma/beta), the same call
    on x widened to f32 and cast back."""
    import torch.nn.functional as F

    def direct(x, g, b):
        return F.layer_norm(x, (C,), g, b, 1e-5)

    try:
        direct(x[:1], gamma, beta)
        return direct, "F.layer_norm"
    except RuntimeError:
        def widened(x, g, b):
            return F.layer_norm(x.float(), (C,), g, b, 1e-5).to(x.dtype)
        return widened, "F.layer_norm(x.float()).to(x.dtype)"


def kernel_split_ms(torch, fn, sets, reps):
    """{kernel name: device ms of one call of ``fn``} from torch.profiler
    over ``reps`` calls cycling through the argument ``sets`` (after a
    warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + getattr(
                e, "self_device_time_total", 0.0) / 1e3 / reps
    return out


def _split_text(split):
    return ", ".join(f"{k} {v:.4f} ms" for k, v in
                     sorted(split.items(), key=lambda kv: -kv[1]))


def _counters():
    """The port's launch counters: name -> (module, attribute)."""
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    return {"K1": (fa, "launches"), "K2": (fa, "bwd_launches"),
            "K4": (ln, "launches"), "K4b": (ln, "bwd_launches"),
            "K3f": (fb, "launches"), "K3b": (fb, "bwd_launches"),
            "K5": (dp, "launches"), "K6f": (fb, "gd_launches"),
            "K6b": (fb, "gd_bwd_launches"), "fold": (dp, "fold_launches")}


def _layout_counters():
    """The row kernels' launch counters by layout: name -> Counter."""
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    return {"K4": ln.layout_launches, "K4b": ln.bwd_layout_launches,
            "K3f": fb.layout_launches, "K3b": fb.bwd_layout_launches}


def reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    for counter in _layout_counters().values():
        counter.clear()


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def read_layout_counts():
    return {k: dict(c) for k, c in _layout_counters().items()}


def train_attn_cases(torch, dev):
    """K2 inputs as the BERT-base step gives them: q, k, v strided views of
    one (B, T, 3, H, d) projection output ("bthd"), not causal, without and
    with lengths; plus a causal T = 1000 case, which GPT training hits."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, causal, with_len in ((TRAIN_B, TRAIN_T, False, False),
                                       (TRAIN_B, TRAIN_T, False, True),
                                       (N, 1000, True, False)):
            g = torch.Generator(device=dev).manual_seed(t + with_len)
            qkv = torch.randn(b, t, 3, H, D, generator=g, device=dev)
            do = torch.randn(b, t, H, D, generator=g, device=dev)
            lens = (torch.randint(1, t + 1, (b,), generator=g, device=dev)
                    if with_len else None)
            cases.append(dict(base=qkv.to(dtype), do=do.to(dtype),
                              lengths=lens, causal=causal, b=b, t=t,
                              dtype=dtype))
    return cases


def train_row_cases(torch, dev):
    """(8192, 768) rows as the BERT-base step's LayerNorm and residual
    sites give them: f32, bf16, and AMP's layouts, f32 x with bf16 h and
    f32 gamma/beta (K3, also at 1000 rows) and bf16 x with f32
    gamma/beta (K4b, also at N rows); K3 at p = 0.1 and p = 0."""
    from incubator_mxnet_tpu_torch.ops.layer_norm import layout_name

    f32, bf16 = torch.float32, torch.bfloat16
    k3, k4b = [], []
    specs = [(f32, f32, f32, ROWS, True), (bf16, bf16, bf16, ROWS, True),
             (f32, bf16, f32, ROWS, False), (f32, bf16, f32, 1000, False),
             (bf16, bf16, f32, ROWS, True), (bf16, bf16, f32, N, True)]
    for xdt, hdt, pdt, rows, is_ln in specs:
        g = torch.Generator(device=dev).manual_seed(17)
        x = torch.randn(rows, C, generator=g, device=dev) + 0.3
        h = torch.randn(rows, C, generator=g, device=dev)
        dy = torch.randn(rows, C, generator=g, device=dev)
        gamma = 1 + 0.3 * torch.randn(C, generator=g, device=dev)
        beta = 0.3 * torch.randn(C, generator=g, device=dev)
        t = dict(x=x.to(xdt), h=h.to(hdt), dy=dy.to(xdt),
                 gamma=gamma.to(pdt), beta=beta.to(pdt), dtype=xdt,
                 rows=rows)
        if xdt == pdt or not is_ln:  # the residual kernels' layouts
            k3 += [dict(t, p=p, key=(1234567, 7654321),
                        layout=layout_name(xdt, pdt, hdt))
                   for p in (TRAIN_P, 0.0)]
        if is_ln:
            k4b.append(dict(t, layout=layout_name(xdt, pdt)))
    return k3, k4b


def train_dropout_cases(torch, dev):
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for cols in (C, FFN):
            g = torch.Generator(device=dev).manual_seed(cols)
            x = torch.randn(ROWS, cols, generator=g, device=dev)
            cases.append(dict(x=x.to(dtype), cols=cols, dtype=dtype,
                              key=(2718281828, 3141592653), p=TRAIN_P))
    return cases


def _log_check(tag, what, dtype, ok, err, rel, tol):
    """Log (and require) a check of an output of ``dtype``."""
    log(f"[{tag}] {what}: max|d|={err:.3e} "
        f"({tol_text(_dt(dtype), tol)}: {'ok' if ok else 'EXCEEDED'}),"
        f" |d|/|plain|={rel:.3e}")
    check(ok, f"{tag} {what} disagrees with plain")


def _column_check(tag, what, got, ref, terms, rows=ROWS, bf16_sums=False):
    """dgamma/dbeta: float32 within column_sum_tol of each column (on the
    grid the kernel ran for ``rows`` rows); bfloat16 by the elementwise
    rule, or with ``bf16_sums`` within one spacing of the plain value plus
    twice that bound (each side rounds its own f32 sum once; at many rows
    a column can cancel to a value whose f32 order error exceeds its
    spacing)."""
    import torch

    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    d = (got.float() - ref.float()).abs()
    rel = (d.norm() / ref.float().norm().clamp_min(1e-30)).item()
    if got.dtype == torch.bfloat16 and not bf16_sums:
        ok, err, rel = agree(got, ref, 0.0)
        _log_check(tag, what, got.dtype, ok, err, rel, 0.0)
        return err
    tol = ln.column_sum_tol(terms, rows,
                            ln.row_blocks(rows, ln.sm_count(got.device)))
    if got.dtype == torch.bfloat16:
        tol = BF16_RTOL * ref.float().abs() + 2 * tol
    ok = bool((d <= tol).all())
    log(f"[{tag}] {what}: max|d|={d.max().item():.3e} (tol per column "
        f"{tol.min().item():.2e}..{tol.max().item():.2e}: "
        f"{'ok' if ok else 'EXCEEDED'}), |d|/|plain|={rel:.3e}")
    check(ok, f"{tag} {what} disagrees with plain")
    return d.max().item()


def phase_train_kernels_vs_plain(torch, dev):
    """The training kernels against their plain versions at the shapes of
    the BERT-base step; dropout masks bit for bit."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    attn = train_attn_cases(torch, dev)
    for c in attn:
        q, k, v = c["base"].unbind(2)
        kw = dict(lengths=c["lengths"], causal=c["causal"], layout="bthd")
        o, lse = fa.flash_attention_with_lse(q, k, v, impl="kernel", **kw)
        c.update(o=o, lse=lse)
        got = fa.flash_attention_bwd(q, k, v, o, lse, c["do"], impl="kernel",
                                     **kw)
        ref = fa.flash_attention_bwd(q, k, v, o, lse, c["do"], impl="plain",
                                     **kw)
        torch.cuda.synchronize()
        what = (f"B={c['b']} T={c['t']} {_dt(c['dtype'])} "
                f"causal={c['causal']} lengths={c['lengths'] is not None}")
        errs = []
        for name, gt, rf in zip(("dq", "dk", "dv"), got, ref):
            check(bool(torch.isfinite(gt.float()).all()),
                  f"K2 {name} not finite")
            ok, err, rel, top = agree_attn(gt, rf, ATTN_BWD_TOL)
            log(f"[K2] {what} {name} (max|plain|="
                f"{rf.float().abs().max().item():.2f}): max|d|={err:.3e}, "
                f"/max|plain|={top:.3e}, |d|/|plain|={rel:.3e} "
                f"({tol_text(_dt(c['dtype']), ATTN_BWD_TOL, attn=True)}: "
                f"{'ok' if ok else 'EXCEEDED'})")
            check(ok, f"K2 {what} {name} disagrees with plain")
            errs.append((err, rel))
        c["max_abs_err"] = max(e for e, _ in errs)
        c["norm_rel_err"] = max(r for _, r in errs)

    k3, k4b = train_row_cases(torch, dev)
    for c in k3:
        rows, p, key = c["rows"], c["p"], c["key"]
        args = (c["x"], c["h"], c["gamma"], c["beta"], key, p)
        y, m, r = fb.residual_dropout_ln_fwd(*args, impl="kernel")
        yp, mp, rp = fb.residual_dropout_ln_fwd(*args, impl="plain")
        bargs = (c["x"], c["h"], c["dy"], mp, rp, c["gamma"], key, p)
        got = fb.residual_dropout_ln_bwd(*bargs, impl="kernel")
        ref = fb.residual_dropout_ln_bwd(*bargs, impl="plain")
        torch.cuda.synchronize()
        what = f"({rows}, {C}) {c['layout']} p={p}"
        check(y.dtype == c["x"].dtype and got[0].dtype == c["x"].dtype
              and got[1].dtype == c["h"].dtype
              and got[2].dtype == got[3].dtype == c["gamma"].dtype,
              f"K3 {what}: output dtypes")
        ok, err, rel = agree(y, yp, LN_TOL)
        serr = max((m - mp).abs().max().item(), (r - rp).abs().max().item())
        _log_check("K3 fwd", f"{what} y", y.dtype, ok and serr <= STATS_TOL,
                   err, rel, LN_TOL)
        log(f"[K3 fwd] {what} max|stats-plain|={serr:.3e} "
            f"(tol {STATS_TOL:g})")
        c["fwd_err"], c["fwd_rel"] = err, rel
        errs = []
        for name, gt, rf in zip(("dx", "dh"), got[:2], ref[:2]):
            ok, err, rel = agree(gt, rf, LN_TOL)
            _log_check("K3 bwd", f"{what} {name}", gt.dtype, ok, err, rel,
                       LN_TOL)
            errs.append(err)
        s = c["x"].float() + fb._dropped(c["h"], key, p)
        xhat = (s - mp[:, None]) * rp[:, None]
        dyf = c["dy"].float()
        errs.append(_column_check("K3 bwd", f"{what} dgamma", got[2],
                                  ref[2], (dyf * xhat).abs().sum(0), rows))
        errs.append(_column_check("K3 bwd", f"{what} dbeta", got[3],
                                  ref[3], dyf.abs().sum(0), rows))
        c["bwd_err"], c["bwd_rel"] = max(errs), rel
        if p > 0:  # the kernel's mask is the plain Philox mask
            keep = ph.keep_mask((rows, C), key, p, device=dev)
            same = torch.equal(got[1] != 0, keep & (ref[1] != 0))
            log(f"[K3 bwd] {what} mask (dh != 0) equals the plain Philox "
                f"mask: {same}")
            check(same, "K3 mask differs from the plain Philox mask")
        if c["h"].dtype != c["x"].dtype:
            _mixed_k3_checks(torch, c, (y, m, r), got, mp, rp)

    for c in k4b:
        rows = c["rows"]
        _, mp, rp = ln.layer_norm_fwd(c["x"], c["gamma"], c["beta"],
                                      impl="plain")
        c.update(mean=mp, rstd=rp)
        bargs = (c["x"], c["dy"], mp, rp, c["gamma"])
        got = ln.layer_norm_bwd(*bargs, impl="kernel")
        again = ln.layer_norm_bwd(*bargs, impl="kernel")
        ref = ln.layer_norm_bwd(*bargs, impl="plain")
        torch.cuda.synchronize()
        what = f"({rows}, {C}) {c['layout']}"
        check(got[0].dtype == c["x"].dtype
              and got[1].dtype == got[2].dtype == c["gamma"].dtype,
              f"K4b {what}: output dtypes")
        ok, err, rel = agree(got[0], ref[0], LN_TOL)
        _log_check("K4b", f"{what} dx", got[0].dtype, ok, err, rel, LN_TOL)
        xhat = (c["x"].float() - mp[:, None]) * rp[:, None]
        dyf = c["dy"].float()
        errs = [err,
                _column_check("K4b", f"{what} dgamma", got[1], ref[1],
                              (dyf * xhat).abs().sum(0), rows),
                _column_check("K4b", f"{what} dbeta", got[2], ref[2],
                              dyf.abs().sum(0), rows)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[K4b] {what}: two calls bitwise equal (dx, dgamma, dbeta "
            f"in {_dt(got[1].dtype)}): {same}")
        check(same, f"K4b {what}: two calls differ")
        c["max_abs_err"], c["norm_rel_err"] = max(errs), rel

    drop = train_dropout_cases(torch, dev)
    for c in drop:
        y = dp.dropout_fwd(c["x"], c["key"], c["p"], impl="kernel")
        yp = dp.dropout_fwd(c["x"], c["key"], c["p"], impl="plain")
        torch.cuda.synchronize()
        keep = ph.keep_mask(c["x"].shape, c["key"], c["p"], device=dev)
        same = torch.equal(y, yp)
        mask = torch.equal(y != 0, keep & (c["x"] != 0))
        log(f"[K5] ({ROWS}, {c['cols']}) {_dt(c['dtype'])} p={c['p']}: "
            f"output equals plain bit for bit: {same}; mask equals the "
            f"plain Philox mask: {mask}; kept "
            f"{keep.float().mean().item():.5f}")
        check(same and mask, "K5 disagrees with plain")
        c["max_abs_err"] = (y.float() - yp.float()).abs().max().item()
        c["norm_rel_err"] = 0.0
    return attn, k3, k4b, drop


def _mixed_k3_checks(torch, c, fwd, got, mp, rp):
    """AMP's K3 layout (f32 x, bf16 h): the forward and backward equal
    the f32 kernels on h widened to f32, bit for bit (dh rounded to bf16
    once), two backward calls are bitwise equal, and at p > 0 the zeros
    of dh are the dropout kernel's (K5) mask for the same key."""
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    rows, p, key = c["rows"], c["p"], c["key"]
    what = f"({rows}, {C}) {c['layout']} p={p}"
    h32 = c["h"].float()
    f32 = fb.residual_dropout_ln_fwd(c["x"], h32, c["gamma"], c["beta"],
                                     key, p, impl="kernel")
    bargs = (c["x"], c["h"], c["dy"], mp, rp, c["gamma"], key, p)
    g32 = fb.residual_dropout_ln_bwd(c["x"], h32, *bargs[2:], impl="kernel")
    again = fb.residual_dropout_ln_bwd(*bargs, impl="kernel")
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(fwd, f32))
            and torch.equal(got[0], g32[0])
            and torch.equal(got[1], g32[1].bfloat16())
            and torch.equal(got[2], g32[2]) and torch.equal(got[3], g32[3]))
    log(f"[K3 mixed] {what}: y, mean, rstd, dx, dh, dgamma, dbeta equal "
        f"the f32 kernels' on h widened to f32 bit for bit: {same}")
    check(same, f"K3 {what} differs from the f32 kernels on widened h")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[K3 mixed] {what}: two backward calls bitwise equal (dgamma, "
        f"dbeta in {_dt(got[2].dtype)}): {same}")
    check(same, f"K3 {what}: two calls differ")
    if p > 0:
        k5 = dp.dropout_fwd(torch.ones_like(c["h"]), key, p,
                            impl="kernel") != 0
        same = torch.equal(got[1] != 0, k5 & (got[0] != 0))
        log(f"[K3 mixed] {what}: dh's zeros are the dropout kernel's mask "
            f"bit for bit: {same}")
        check(same, f"K3 {what}: mask differs from K5's")


def phase_row_bwd_checks(torch, dev):
    """The row backward (K4b, and K3's backward with dropout) against its
    plain version where the grid and the vector count change: rows past
    one resident wave (65536, BERT-base at sequence 512), one row, and
    widths at each vector count a lane can take apart (ROW_BWD_NV); two
    calls give bitwise-equal dx, dh, dgamma and dbeta."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    shapes = []
    for dtype in (torch.float32, torch.bfloat16):
        vec = 16 // (torch.finfo(dtype).bits // 8)
        shapes += [(dtype, rows, C) for rows in (1, GD_LARGE[0])]
        shapes += [(dtype, ROW_BWD_ROWS, nv * 32 * vec) for nv in ROW_BWD_NV]
    key, p = (1234567, 7654321), TRAIN_P
    for dtype, rows, cols in shapes:
        g = torch.Generator(device=dev).manual_seed(rows + cols)
        x, h, dy = (torch.randn(rows, cols, generator=g, device=dev)
                    for _ in range(3))
        x = (x + 0.3).to(dtype)
        h, dy = h.to(dtype), dy.to(dtype)
        gamma = (1 + 0.3 * torch.randn(cols, generator=g, device=dev)).to(
            dtype)
        beta = (0.3 * torch.randn(cols, generator=g, device=dev)).to(dtype)
        what = f"({rows}, {cols}) {_dt(dtype)}"
        dyf = dy.float()
        for kind in ("K4b", "K3 p=0.1"):
            if kind == "K4b":
                _, mp, rp = ln.layer_norm_fwd(x, gamma, beta, impl="plain")
                args = (x, dy, mp, rp, gamma)
                run, s = ln.layer_norm_bwd, x.float()
                names = ("dx", "dgamma", "dbeta")
            else:
                _, mp, rp = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key,
                                                       p, impl="plain")
                args = (x, h, dy, mp, rp, gamma, key, p)
                run, s = fb.residual_dropout_ln_bwd, (
                    x.float() + fb._dropped(h, key, p))
                names = ("dx", "dh", "dgamma", "dbeta")
            got = run(*args, impl="kernel")
            again = run(*args, impl="kernel")
            ref = run(*args, impl="plain")
            torch.cuda.synchronize()
            xhat = (s - mp[:, None]) * rp[:, None]
            terms = {"dgamma": (dyf * xhat).abs().sum(0),
                     "dbeta": dyf.abs().sum(0)}
            for name, gt, rf in zip(names, got, ref):
                check(gt.dtype == dtype and gt.shape == rf.shape,
                      f"row bwd {kind} {what} {name}: dtype or shape")
                if name in terms:
                    _column_check("row bwd", f"{kind} {what} {name}", gt,
                                  rf, terms[name], rows, bf16_sums=True)
                else:
                    ok, err, rel = agree(gt, rf, LN_TOL)
                    _log_check("row bwd", f"{kind} {what} {name}", gt.dtype,
                               ok, err,
                               rel, LN_TOL)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"[row bwd] {kind} {what}: two calls bitwise equal "
                f"(dgamma, dbeta and the rest): {same}")
            check(same, f"row bwd {kind} {what}: two calls differ")
            if kind != "K4b":  # dh = dx * scale where kept, else 0
                keep = ph.keep_mask((rows, cols), key, p, device=dev)
                same = torch.equal(got[1] != 0, keep & (got[0] != 0))
                log(f"[row bwd] {kind} {what}: dh's zeros are the plain "
                    f"Philox mask's: {same}")
                check(same, f"row bwd {kind} {what}: mask differs from K5's")


def phase_train_step_check(torch, dev):
    """One BERT-base step at full width on the kernels against the same
    step on the plain versions: same weights, same dropout keys."""
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base

    models = {impl: bert_base(dropout=TRAIN_P, device=dev, seed=21,
                              impl=impl).train()
              for impl in ("auto", "plain")}
    models["plain"].load_state_dict(models["auto"].state_dict())
    g = torch.Generator(device=dev).manual_seed(5)
    tok = torch.randint(0, BERT_VOCAB, (CHECK_B, CHECK_T), generator=g,
                        device=dev)
    lab = torch.randint(0, BERT_VOCAB, (CHECK_B, CHECK_T), generator=g,
                        device=dev)
    vl = torch.randint(CHECK_T // 2, CHECK_T + 1, (CHECK_B,), generator=g,
                       device=dev)
    ce = SoftmaxCrossEntropyLoss()
    out = {}
    for impl, model in models.items():
        mxrandom.seed(99)
        reset_counts()
        loss = ce(model(tok, valid_length=vl)[0], lab).mean()
        loss.backward()
        torch.cuda.synchronize()
        out[impl] = (loss.item(), read_counts(),
                     {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    (lk, ck, gk), (lp, cp, gp) = out["auto"], out["plain"]
    log(f"[check] BERT-base {CHECK_B} x {CHECK_T}, valid_length "
        f"{vl.tolist()}, dropout {TRAIN_P}: launches with kernels {ck}, "
        f"with plain versions {cp}")
    check(ck == STEP_LAUNCHES and not any(cp.values()),
          "train-step check: unexpected launch counts")
    loss_rel = abs(lk - lp) / abs(lp)
    check(set(gk) == set(gp), "train-step check: gradients differ in names")
    worst, worst_name = 0.0, None
    for name in gp:
        scale = gp[name].abs().max().item()
        rel = (gk[name] - gp[name]).abs().max().item() / max(scale, 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[check] loss kernels {lk:.6f} vs plain {lp:.6f} "
        f"(|d|/|plain| {loss_rel:.2e}, tol {LOSS_REL_TOL:g}); {len(gp)} "
        f"gradients, worst max|d| / max|plain| {worst:.2e} ({worst_name}; "
        f"tol {GRAD_REL_TOL:g})")
    check(loss_rel <= LOSS_REL_TOL and worst <= GRAD_REL_TOL,
          "train-step check: the kernels' step disagrees with the plain one")
    return dict(batch=CHECK_B, seq=CHECK_T, valid_length=vl.tolist(),
                loss_kernels=lk, loss_plain=lp, loss_rel_err=loss_rel,
                grad_worst_rel_err=worst, grad_worst_param=worst_name,
                n_grads=len(gp))


def _device_ms(prof, skip=None):
    """Sum of the device time of the kernels, copies and sets in a
    profiler trace, in ms (one stream, so their sum is the busy time);
    ``skip``: a name part of kernels left out (a spin that delays the
    work)."""
    from torch.autograd import DeviceType

    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not (skip and skip in e.key):
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3


# the layouts the AMP step's row kernels must take, launches a step (the
# MLM LayerNorm bf16 x with f32 gamma/beta; the encoder LayerNorm f32;
# every residual site f32 x with a bf16 h)
AMP_K3 = "f32 x, bf16 h, f32 gamma"
AMP_K4 = "bf16 x, f32 gamma"
AMP_LAYOUT_LAUNCHES = {"K4": {"f32": 1, AMP_K4: 1},
                       "K4b": {"f32": 2, AMP_K4: 2},
                       "K3f": {AMP_K3: 24}, "K3b": {AMP_K3: 48}}
# the peak a training mode's model-FLOPs share is of: its products' rate
# (bench.py's cell runs under amp.init("bfloat16"): bf16 tensor cores)
TRAIN_MODES = {"f32": "float32", "amp": "bfloat16", "tf32": "tf32"}
F32_LAYOUT_LAUNCHES = {k: {"f32": sum(v.values())}
                       for k, v in AMP_LAYOUT_LAUNCHES.items()}


def phase_train(torch, dev, mode="f32"):
    """The bench.py BERT-base training workload, 2 warm-up + 10 timed
    steps, launch counts per step (by layout under AMP), and one profiled
    step. ``mode``: "f32" (TF32 off), "amp" (under amp.init("bfloat16"),
    deinit in a finally), or "tf32" (f32 with TF32 products, restored
    after)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam

    tag = {"f32": "train", "amp": "train amp", "tf32": "train tf32"}[mode]
    model = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                      seed=0).train()
    trainer = Trainer(model.named_parameters(), Adam(learning_rate=TRAIN_LR))
    ce = SoftmaxCrossEntropyLoss()
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    n_params = sum(p.numel() for p in model.parameters())

    def step(fwd_counts=None):
        model.zero_grad(set_to_none=True)
        loss = ce(model(tokens)[0], labels)
        if fwd_counts is not None:
            fwd_counts.append(read_counts())
        loss.backward(torch.ones_like(loss))
        trainer.step(TRAIN_B)
        return loss

    tf32_was = torch.backends.cuda.matmul.allow_tf32
    if mode == "amp":
        amp.init("bfloat16")
    elif mode == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        mxrandom.seed(0)
        losses, times, per_step, by_layout = [], [], [], []
        for i in range(WARMUP + STEPS):
            fwd = []
            reset_counts()
            start = time.perf_counter()
            loss = step(fwd)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            counts = read_counts()
            losses.append(loss.mean().item())
            check(fwd[0] == FWD_LAUNCHES and counts == STEP_LAUNCHES,
                  f"{tag} step {i}: launches {fwd[0]} after the forward, "
                  f"{counts} after the step; expected {FWD_LAUNCHES}, "
                  f"{STEP_LAUNCHES}")
            layouts = read_layout_counts()
            want = (AMP_LAYOUT_LAUNCHES if mode == "amp"
                    else F32_LAYOUT_LAUNCHES)
            check(layouts == want, f"{tag} step {i}: launches by layout "
                  f"{layouts}, expected {want}")
            per_step.append(counts)
            by_layout.append(layouts)
        timed = sorted(times[WARMUP:])
        med = timed[len(timed) // 2 - 1] / 2 + timed[len(timed) // 2] / 2
        totals = {k: sum(c[k] for c in per_step[WARMUP:])
                  for k in STEP_LAUNCHES}
        layout_totals = {k: {n: sum(b[k][n] for b in by_layout[WARMUP:])
                             for n in by_layout[-1][k]}
                         for k in by_layout[-1]}
        log(f"[{tag}] BERT-base {TRAIN_B} x {TRAIN_T}, dropout {TRAIN_P}, "
            f"Adam lr {TRAIN_LR}, {n_params} parameters: step ms "
            + ", ".join(f"{t:.1f}" for t in times)
            + f" ({WARMUP} warm-up); loss " + ", ".join(f"{v:.4f}"
                                                        for v in losses))
        log(f"[{tag}] launches per step {STEP_LAUNCHES} (forward "
            f"{FWD_LAUNCHES}), by layout {by_layout[-1]}: every step as "
            f"expected")
        check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite "
              f"loss")
        check(losses[-1] < losses[WARMUP], f"{tag}: the loss did not fall")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        amp.deinit()
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    dev_ms = _device_ms(prof)
    tokens_s = TRAIN_B * TRAIN_T / (med / 1e3)
    flops_token = 6.0 * n_params + 12.0 * 12 * TRAIN_T * C
    peak = TRAIN_MODES[mode]
    share = flops_token * tokens_s / PEAK_FLOPS[peak]
    idle = 1 - dev_ms / med if dev_ms > 0 else None
    log(f"[{tag}] median step {med:.2f} ms, {tokens_s:.1f} tokens/s, "
        f"model FLOPs {flops_token:.4g}/token -> share of the {peak} peak "
        f"({PEAK_FLOPS[peak] / 1e12:g} TFLOP/s) {share:.4f}; device busy "
        f"{dev_ms:.2f} ms of a step (torch.profiler) -> idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured"))
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    by_kernel = [dict(ms=getattr(e, "self_device_time_total", 0) / 1e3,
                      calls=e.count, name=e.key[:160]) for e in top]
    for e in by_kernel[:24 if mode == "amp" else 14]:
        log(f"[{tag}]   {e['ms']:8.3f} ms x{e['calls']:4d}  {e['name'][:90]}")
    row_bwd = {k: sum(getattr(e, "self_device_time_total", 0.0) / 1e3
                      for e in top if k in e.key)
               for k in ("ln_bwd_kernel", "ln_partials_reduce_kernel")}
    log(f"[{tag}] row backward (K3 backward, K4b) in the step: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in row_bwd.items())
        + f", together {sum(row_bwd.values()):.3f} ms")
    if mode == "amp":  # K1/K2 took the bf16 kernels (no cast to f32)
        flash = [e["name"] for e in by_kernel if "flash_" in e["name"]]
        check(flash and all("bfloat16" in n for n in flash),
              f"{tag}: flash kernels in the step not all bf16: {flash}")
        log(f"[{tag}] flash-attention kernels in the step, all bf16: "
            f"{len(flash)} names")
    del model, trainer
    return dict(mode=mode, batch=TRAIN_B, seq=TRAIN_T, dropout=TRAIN_P,
                lr=TRAIN_LR, params=n_params, step_ms=times, warmup=WARMUP,
                median_step_ms=med, tokens_per_s=tokens_s,
                flops_per_token=flops_token, peak=peak,
                peak_share=share, device_ms_per_step=dev_ms,
                idle_share=idle, losses=losses,
                row_bwd_device_ms=row_bwd,
                device_ms_by_kernel=by_kernel[:40],
                launches_per_step=STEP_LAUNCHES,
                launches_by_layout_per_step=by_layout[-1]), (
                    totals, layout_totals)


# the DataParallel step's launches a step: the eager step's, plus the fold
# kernel once (the step's first dropout site fills the chunk of its key
# table that all 49 sites share)
DP_STEP_LAUNCHES = dict(STEP_LAUNCHES, fold=1)
# the fold kernel's work: KEY_CHUNK sites, each two Philox4x32-10 blocks of
# 10 rounds of ~12 integer operations, counted at the f32 rate of the CUDA
# cores (the data sheet gives no integer rate outside the tensor cores)
FOLD_OPS_PER_SITE = 2 * 10 * 12
# the spin ahead of a profiled replay (`torch.cuda._sleep`), ~25 ms at the
# H100's clocks, and its kernel's name, left out of the device time
SPIN_CYCLES = 50_000_000
SPIN_KERNEL = "spin_kernel"


def _profile_counts(prof):
    """(launches of the port's kernels in a profiled window, in the
    counters' units, from the kernels' names; the row backward's
    reduction kernels seen). A K3b or K4b call counts its row kernel and
    its reduction, as the counters do."""
    import re

    from torch.autograd import DeviceType

    out = {k: 0 for k in DP_STEP_LAUNCHES}
    reduce = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key, n = e.key, e.count
        row = re.search(r"ln_(fwd|bwd)_kernel<([^>]*)>", key)
        gd = re.search(r"gelu_dropout_kernel<([^>]*)>", key)
        if "flash_fwd_kernel" in key:
            out["K1"] += n
        elif re.search(r"flash_bwd_(delta|dq|dkv)_kernel", key):
            out["K2"] += n
        elif row:
            mode = int(row.group(2).split(",")[-1])
            if row.group(1) == "fwd":
                out["K4" if mode == 0 else "K3f"] += n
            else:
                out["K4b" if mode == 0 else "K3b"] += 2 * n
        elif "ln_partials_reduce_kernel" in key:
            reduce += n
        elif gd:
            bwd = gd.group(1).split(",")[-1].strip() == "true"
            out["K6b" if bwd else "K6f"] += n
        elif "::dropout_kernel<" in key:
            out["K5"] += n
        elif "fold_keys_kernel" in key:
            out["fold"] += n
    return out, reduce


def phase_device_keys(torch, dev):
    """K5, K3 and K6 on a device key (the keys of a step replayed as a
    CUDA graph) at the training step's shapes: every output bit for bit
    the by-value launch's for the same words, the mask the plain
    version's (and the plain version on the device key the plain version
    on the words); the fold kernel's table the plain fold's; and a
    captured graph of the three, replayed at two values of t, drops other
    elements at each, those of the by-value launches for that t's words.
    Returns the fold kernel's case for the timing and the kernels line."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    base = torch.tensor([2718281828, 3141592653], device=dev)
    t = torch.tensor(7, device=dev)

    def key(site):
        return ph.DeviceKey(base, t, site, {})

    def words(site):
        return tuple(int(w) for w in ph.key_words(key(site)))

    first = key(0)
    dp.site_key_ptr(first, dev)
    sites = torch.arange(dp.KEY_CHUNK, device=dev)
    plain = torch.stack(ph.fold(ph.fold((base[0], base[1]), t), sites), 1)
    table = first.tables[0].long() & 0xFFFFFFFF
    check(torch.equal(table, plain), "fold kernel: the key table differs "
          "from the plain fold")
    log(f"[keys] fold kernel: {dp.KEY_CHUNK} site keys of t = {int(t)} "
        f"equal the plain fold's, bit for bit")

    g = torch.Generator(device=dev).manual_seed(41)
    f32, bf16 = torch.float32, torch.bfloat16
    site = 37
    k, w = key(site), words(site)
    for dtype in (f32, bf16):
        for cols in (C, FFN):
            x = torch.randn(ROWS, cols, generator=g, device=dev).to(dtype)
            keep = ph.keep_mask(x.shape, w, TRAIN_P, device=dev)
            y = dp.dropout_fwd(x, k, TRAIN_P, impl="kernel")
            check(torch.equal(y, dp.dropout_fwd(x, w, TRAIN_P,
                                                impl="kernel"))
                  and torch.equal(y, dp.dropout_fwd(x, k, TRAIN_P,
                                                    impl="plain"))
                  and torch.equal((y != 0) | (x == 0), keep | (x == 0)),
                  f"K5 device key ({ROWS}, {cols}) {_dt(dtype)}")
            if cols == FFN:
                gd = fb.gelu_dropout_fwd(x, k, TRAIN_P, impl="kernel")
                gdb = fb.gelu_dropout_bwd(x, x, k, TRAIN_P, impl="kernel")
                check(torch.equal(gd, fb.gelu_dropout_fwd(
                    x, w, TRAIN_P, impl="kernel"))
                    and torch.equal(gdb, fb.gelu_dropout_bwd(
                        x, x, w, TRAIN_P, impl="kernel"))
                    and torch.equal(fb.gelu_dropout_fwd(
                        x, k, TRAIN_P, impl="plain"), fb.gelu_dropout_fwd(
                        x, w, TRAIN_P, impl="plain"))
                    and torch.equal((gd != 0) | (x == 0), keep | (x == 0)),
                    f"K6 device key ({ROWS}, {cols}) {_dt(dtype)}")
            log(f"[keys] K5" + (" and K6 (forward, backward)"
                                if cols == FFN else "")
                + f" ({ROWS}, {cols}) {_dt(dtype)}, site {site}: device "
                f"key = by-value words = plain, bit for bit")
    for xdt, hdt in ((f32, f32), (bf16, bf16), (f32, bf16)):
        x = torch.randn(ROWS, C, generator=g, device=dev).to(xdt)
        h = torch.randn(ROWS, C, generator=g, device=dev).to(hdt)
        dy = torch.randn(ROWS, C, generator=g, device=dev).to(xdt)
        pdt = bf16 if xdt == bf16 else f32
        gamma = (1 + 0.3 * torch.randn(C, generator=g, device=dev)).to(pdt)
        beta = (0.3 * torch.randn(C, generator=g, device=dev)).to(pdt)
        outs = []
        for kk in (k, w):
            y, mean, rstd = fb.residual_dropout_ln_fwd(
                x, h, gamma, beta, kk, TRAIN_P, impl="kernel")
            outs.append((y, mean, rstd) + fb.residual_dropout_ln_bwd(
                x, h, dy, mean, rstd, gamma, kk, TRAIN_P, impl="kernel"))
        dh = outs[0][4]
        keep = ph.keep_mask(h.shape, w, TRAIN_P, device=dev)
        pk = fb.residual_dropout_ln_fwd(x, h, gamma, beta, k, TRAIN_P,
                                        impl="plain")
        pw = fb.residual_dropout_ln_fwd(x, h, gamma, beta, w, TRAIN_P,
                                        impl="plain")
        check(all(torch.equal(a, b) for a, b in zip(*outs))
              and all(torch.equal(a, b) for a, b in zip(pk, pw))
              and torch.equal(dh != 0, keep),
              f"K3 device key {_dt(xdt)} x, {_dt(hdt)} h")
        log(f"[keys] K3 ({ROWS}, {C}) {_dt(xdt)} x, {_dt(hdt)} h, site "
            f"{site}: forward and backward, device key = by-value words, "
            f"bit for bit; the mask (dh != 0) the plain version's")

    # a graph of the three with device keys, replayed at t = 7 and t = 8
    x = torch.randn(ROWS, FFN, generator=g, device=dev).to(bf16)
    xr = torch.randn(ROWS, C, generator=g, device=dev)
    hr = torch.randn(ROWS, C, generator=g, device=dev).to(bf16)
    gr, br = torch.ones(C, device=dev), torch.zeros(C, device=dev)

    def three():
        return (dp.dropout_fwd(x, key(0), TRAIN_P),
                fb.residual_dropout_ln_fwd(xr, hr, gr, br, key(1),
                                           TRAIN_P)[0],
                fb.gelu_dropout_fwd(x, key(2), TRAIN_P))

    three()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = three()
    masks = []
    for step in (7, 8):
        t.fill_(step)
        graph.replay()
        torch.cuda.synchronize()
        ref = (dp.dropout_fwd(x, words(0), TRAIN_P),
               fb.residual_dropout_ln_fwd(xr, hr, gr, br, words(1),
                                          TRAIN_P)[0],
               fb.gelu_dropout_fwd(x, words(2), TRAIN_P))
        check(all(torch.equal(a, b) for a, b in zip(outs, ref)),
              f"replay at t = {step}: not the by-value launches' outputs")
        masks.append([o != 0 for o in (outs[0], outs[2])] + [outs[1].clone()])
    check(not any(torch.equal(a, b) for a, b in zip(*masks)),
          "two replays at t = 7 and 8 gave the same masks")
    log("[keys] a graph of K5, K3 and K6 on device keys, replayed at t = 7 "
        "and t = 8: each replay equals the by-value launches for its "
        "words, and the two drop other elements")
    del graph
    return dict(dtype=torch.int32, layout="", max_abs_err=0.0,
                norm_rel_err=0.0, base=base, t=t, sites=sites)


def phase_times_device_keys(torch, c):
    """The fold kernel (one chunk of site keys) and its plain version; and
    K5, K3 (forward, backward) and K6 forward at the AMP step's shapes on
    a device key against the same launch by value, in turns (kernel
    times, the key's table already filled)."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    base, t, sites, dev = c["base"], c["t"], c["sites"], c["base"].device
    c["ms"] = time_ms(lambda: dp.site_key_ptr(
        ph.DeviceKey(base, t, 0, {}), dev), [()], 20)
    c["plain_ms"] = time_ms(lambda: ph.fold(ph.fold((base[0], base[1]), t),
                                            sites), [()], 5)
    c["library_ms"] = None
    n = dp.KEY_CHUNK
    c["bound_ms"], c["bound_by"] = bound(3 * 8 + n * 8,
                                         n * FOLD_OPS_PER_SITE, "float32")
    log(f"[time] fold kernel ({n} site keys): kernel {c['ms']:.4f} ms, "
        f"plain {c['plain_ms']:.4f} ms, no library call, bound "
        f"{c['bound_ms']:.2e} ms ({c['bound_by']}): a launch's cost")

    key = ph.DeviceKey(base, t, 3, {})
    words = tuple(int(w) for w in ph.key_words(key))
    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.randn(ROWS, FFN, generator=g, device=dev).bfloat16()
    xr = torch.randn(ROWS, C, generator=g, device=dev)
    hr = torch.randn(ROWS, C, generator=g, device=dev).bfloat16()
    dy = torch.randn(ROWS, C, generator=g, device=dev)
    gm, bt = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    _, m, r = fb.residual_dropout_ln_fwd(xr, hr, gm, bt, words, TRAIN_P)
    cases = {
        "K5 (8192, 3072) bf16": ([x], lambda k, x: dp.dropout_fwd(
            x, k, TRAIN_P)),
        "K3 forward (8192, 768) f32 x, bf16 h": (
            [xr, hr], lambda k, x, h: fb.residual_dropout_ln_fwd(
                x, h, gm, bt, k, TRAIN_P)),
        "K3 backward (8192, 768) f32 x, bf16 h": (
            [xr, hr, dy], lambda k, x, h, d: fb.residual_dropout_ln_bwd(
                x, h, d, m, r, gm, k, TRAIN_P)),
        "K6 forward (8192, 3072) bf16": ([x], lambda k, x: fb.
                                         gelu_dropout_fwd(x, k, TRAIN_P)),
    }
    out = {}
    for what, (tensors, fn) in cases.items():
        sets = input_sets(tensors, 20)
        times = {}
        for name, k in (("value", words), ("device", key), ("device", key),
                        ("value", words)):
            ms = time_ms(lambda *a, k=k, fn=fn: fn(k, *a), sets, 20)
            times.setdefault(name, []).append(ms)
        out[what] = {name: min(v) for name, v in times.items()}
        log(f"[time] {what} p={TRAIN_P}: device key "
            f"{out[what]['device']:.4f} ms, by value "
            f"{out[what]['value']:.4f} ms (best of two, in turns value, "
            f"device, device, value)")
    return out


def phase_train_dp(torch, dev, trainer, mode="amp"):
    """The bench.py workload through `parallel.DataParallel`, the
    reference bench's own trainer (`bench.py:362`): 2 warm-up steps (one
    eager, one that captures the step as a CUDA graph and replays it) and
    10 timed replays. Launches counted by kernel and layout at the eager
    and the capturing step (none on a replay; a profiled replay shows
    them all), one capture, the losses and parameters of the replays
    against `_step_fn` run eagerly from the same state and seed, device
    time by kernel, the optimizer's and the CE's own device time.
    ``trainer``: phase_train's result in the same mode, printed beside.
    ``mode``: "amp" or "f32"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    tag = {"f32": "train dp", "amp": "train dp amp"}[mode]
    ce = SoftmaxCrossEntropyLoss()

    def mlm_loss(out, y):
        return ce(out[0], y)

    nets = [bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                      seed=0) for _ in range(2)]
    dps = [DataParallel(n, mlm_loss, Adam(learning_rate=TRAIN_LR))
           for n in nets]
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    n_params = sum(p.numel() for p in nets[0].parameters())
    want_layout = AMP_LAYOUT_LAUNCHES if mode == "amp" else \
        F32_LAYOUT_LAUNCHES
    none = {k: 0 for k in DP_STEP_LAUNCHES}
    if mode == "amp":
        amp.init("bfloat16")
    try:
        mxrandom.seed(0)
        losses, times, counts, layouts, captures = [], [], [], [], []
        for _ in range(WARMUP + STEPS):
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss = dps[0].step(tokens, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            counts.append(read_counts())
            layouts.append(read_layout_counts())
            captures.append(dps[0].captures)
            losses.append(loss)
        for i, (cn, ly) in enumerate(zip(counts, layouts)):
            cap = i < WARMUP  # the eager and the capturing step
            check(cn == (DP_STEP_LAUNCHES if cap else none)
                  and ly == (want_layout if cap else
                             {k: {} for k in want_layout}),
                  f"{tag} step {i}: launches {cn}, by layout {ly}; "
                  f"expected {DP_STEP_LAUNCHES if cap else none}")
        check(captures == [0] + [1] * (WARMUP + STEPS - 1),
              f"{tag}: captures after each step {captures}, expected one, "
              f"at step 2")
        # the same steps eagerly through the step function, from the same
        # state and seed
        mxrandom.seed(0)
        eager = [dps[1]._step_fn(*dps[1]._prepare(), tokens, labels)
                 for _ in range(WARMUP + STEPS)]
        torch.cuda.synchronize()
        exact = (all(torch.equal(a, b) for a, b in zip(losses, eager))
                 and all(torch.equal(a, b) for a, b in
                         zip(nets[0].parameters(), nets[1].parameters())))
        loss_rel = max(abs(a.item() - b.item()) / abs(b.item())
                       for a, b in zip(losses, eager))
        param_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in zip(nets[0].parameters(),
                                          nets[1].parameters()))
        how = ("bit for bit" if exact else
               f"not bit for bit: losses within {loss_rel:.2e} (tol "
               f"{LOSS_REL_TOL:g}), parameters within {param_rel:.2e} of "
               f"their largest magnitude (tol {GRAD_REL_TOL:g}), "
               f"phase_train_step_check's tolerances")
        check(exact or (loss_rel <= LOSS_REL_TOL
                        and param_rel <= GRAD_REL_TOL),
              f"{tag}: the replays disagree with the eager step function: "
              f"{how}")
        log(f"[{tag}] replays against `_step_fn` run eagerly from the same "
            f"state and seed, {WARMUP + STEPS} steps: losses and all "
            f"{len(list(nets[0].parameters()))} parameters {how}")
        vals = [v.item() for v in losses]
        check(all(math.isfinite(v) for v in vals), f"{tag}: non-finite "
              f"loss")
        check(vals[-1] < vals[WARMUP], f"{tag}: the loss did not fall")

        # one profiled replay. The card spins ~25 ms first, and the
        # recorded replay is the second of the profiler's session, after a
        # warm-up cycle whose records are dropped: a replay profiled as
        # tracing starts can lose its first kernels' records (PERF.md §7);
        # a short trace is profiled again, at most three times, and the
        # tries are reported
        for tries in range(1, 4):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):
                    torch.cuda._sleep(SPIN_CYCLES)
                    dps[0].step(tokens, labels)
                    torch.cuda.synchronize()
                    prof.step()
            seen, reduce = _profile_counts(prof)
            if seen == DP_STEP_LAUNCHES:
                break
        check(seen == DP_STEP_LAUNCHES
              and 2 * reduce == seen["K3b"] + seen["K4b"],
              f"{tag}: a profiled replay launched {seen} (reductions "
              f"{reduce}), expected {DP_STEP_LAUNCHES}")
        # a replay's span on the card, from CUDA events around the step
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        dps[0].step(tokens, labels)
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end)
        # the optimizer's and the MLM CE's own device time a step
        t_, lr_, wd_, _ = dps[1]._prepare()
        grads = [torch.randn_like(p) * 1e-3 for p in dps[1].params]
        adam_ms = time_ms(lambda: dps[1]._update_fn(grads, t_, lr_, wd_),
                          [()], 3)
        del grads
        with torch.no_grad():
            scores = nets[1](tokens)[0]
        scores.requires_grad_()
        ce_ms = time_ms(lambda: torch.autograd.grad(
            mlm_loss((scores,), labels).mean(), scores), [()], 3)
        del scores
    finally:
        amp.deinit()
    timed = sorted(times[WARMUP:])
    med = timed[len(timed) // 2 - 1] / 2 + timed[len(timed) // 2] / 2
    dev_ms = _device_ms(prof, skip=SPIN_KERNEL)
    tokens_s = TRAIN_B * TRAIN_T / (med / 1e3)
    flops_token = 6.0 * n_params + 12.0 * 12 * TRAIN_T * C
    peak = TRAIN_MODES[mode]
    share = flops_token * tokens_s / PEAK_FLOPS[peak]
    idle = 1 - dev_ms / med if dev_ms > 0 else None
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and SPIN_KERNEL not in e.key),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    by_kernel = [dict(ms=getattr(e, "self_device_time_total", 0) / 1e3,
                      calls=e.count, name=e.key[:160]) for e in top]
    log(f"[{tag}] BERT-base {TRAIN_B} x {TRAIN_T}, dropout {TRAIN_P}, Adam "
        f"lr {TRAIN_LR}, {n_params} parameters, DataParallel "
        f"({len(dps[0]._fused)} of {len(dps[0].params)} parameters in the "
        f"small-parameter segment): step ms "
        + ", ".join(f"{t:.2f}" for t in times)
        + f" (step 1 eager, step 2 captures the graph and replays it); "
        f"loss " + ", ".join(f"{v:.4f}" for v in vals))
    log(f"[{tag}] launches at the eager and the capturing step "
        f"{DP_STEP_LAUNCHES}, by layout {want_layout}; none on the "
        f"{STEPS} timed replays (the Python counters do not move); one "
        f"profiled replay launched {seen}: as counted at the capture "
        f"(profiled {tries} time{'s' if tries > 1 else ''})")
    log(f"[{tag}] median step {med:.2f} ms, {tokens_s:.1f} tokens/s, share "
        f"of the {peak} peak {share:.4f}; device busy {dev_ms:.2f} ms of a "
        f"replay (torch.profiler, {sum(e['calls'] for e in by_kernel)} "
        f"kernels) -> idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured")
        + f"; a replay spans {replay_ms:.2f} ms on the card (CUDA events)"
        f"; of it the optimizer {adam_ms:.2f} ms and the MLM CE forward "
        f"and backward {ce_ms:.2f} ms (CUDA events, each alone). The "
        f"Trainer step of this run: median {trainer['median_step_ms']:.2f} "
        f"ms, device {trainer['device_ms_per_step']:.2f} ms, idle share "
        + (f"{trainer['idle_share']:.4f}" if trainer["idle_share"] is not None
           else "not measured"))
    for e in by_kernel[:24]:
        log(f"[{tag}]   {e['ms']:8.3f} ms x{e['calls']:4d}  {e['name'][:90]}")
    totals = {k: sum(cn[k] for cn in counts) for k in DP_STEP_LAUNCHES}
    layout_totals = {k: {n: sum(ly[k].get(n, 0) for ly in layouts)
                         for n in want_layout[k]} for k in want_layout}
    del dps, nets
    return dict(mode=mode, batch=TRAIN_B, seq=TRAIN_T, dropout=TRAIN_P,
                lr=TRAIN_LR, params=n_params, step_ms=times, warmup=WARMUP,
                median_step_ms=med, tokens_per_s=tokens_s,
                flops_per_token=flops_token, peak=peak, peak_share=share,
                device_ms_per_step=dev_ms, idle_share=idle,
                replay_span_ms=replay_ms, profiled_tries=tries,
                optimizer_device_ms=adam_ms, mlm_ce_device_ms=ce_ms,
                losses=vals, captures=captures[-1], capture_step=WARMUP,
                replays_vs_eager=how,
                launches_at_capture=DP_STEP_LAUNCHES,
                launches_in_a_profiled_replay=seen,
                device_ms_by_kernel=by_kernel[:40],
                trainer=dict(median_step_ms=trainer["median_step_ms"],
                             tokens_per_s=trainer["tokens_per_s"],
                             device_ms_per_step=trainer[
                                 "device_ms_per_step"],
                             idle_share=trainer["idle_share"])), (
                    totals, layout_totals)

def phase_times_train(torch, attn, k3, k4b, drop):
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    for c in attn:
        kw = dict(lengths=c["lengths"], causal=c["causal"], layout="bthd")

        def run(base, do, o, lse, impl, kw=kw):
            fa.flash_attention_bwd(*base.unbind(2), o, lse, do, impl=impl,
                                   **kw)

        sets = input_sets([c["base"], c["do"], c["o"], c["lse"]], 10)
        c["ms"] = time_ms(lambda *a: run(*a, "kernel"), sets, 10)
        c["plain_ms"] = time_ms(lambda *a: run(*a, "plain"), sets, 3)
        mask = None
        if c["lengths"] is not None:
            mask = (torch.arange(c["t"], device=c["base"].device)[None, :]
                    < c["lengths"][:, None])[:, None, None, :]

        def lib(base, do, *_, backward=True, c=c, mask=mask):
            leaf = base.detach().requires_grad_()
            q, k, v = (t.transpose(1, 2) for t in leaf.unbind(2))
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 is_causal=c["causal"])
            if backward:
                torch.autograd.grad(out, leaf, do.transpose(1, 2))

        c["library_ms"] = (time_ms(lib, sets, 10) - time_ms(
            lambda *a: lib(*a, backward=False), sets, 10))
        t, b, item = c["t"], c["b"], c["base"].element_size()
        if c["lengths"] is None:
            flops = 5 * 2 * b * H * t * t * D / (2 if c["causal"] else 1)
        else:
            flops = 5 * 2 * H * D * float((c["lengths"].double() ** 2).sum())
        # q, k, v, o, dO read where live; dq, dk, dv, lse and delta in full
        live = live_share(c["lengths"], t)
        c["bound_ms"], c["bound_by"] = bound(
            (5 * live + 3) * b * t * H * D * item + 2 * b * H * t * 4, flops,
            _dt(c["dtype"]), tensor_cores=True)
        log(f"[time] K2 B={b} T={t} {_dt(c['dtype'])} causal={c['causal']} "
            f"lengths={c['lengths'] is not None}: kernel {c['ms']:.4f} ms, "
            f"plain {c['plain_ms']:.4f} ms, sdpa backward "
            f"{c['library_ms']:.4f} ms (kernel/sdpa "
            f"{c['ms'] / c['library_ms']:.2f}), bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), roofline share "
            f"{c['bound_ms'] / c['ms']:.3f}")

    for c in k3:
        gm, bt, key, p = c["gamma"], c["beta"], c["key"], c["p"]
        rows, dt = c["rows"], _ops_dtype(c)
        ix, ih, ip = (t.element_size() for t in (c["x"], c["h"], gm))
        sets = input_sets([c["x"], c["h"]], 20)  # outputs kept: y cycles
        c["ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="kernel"), sets, 20, keep=True)
        c["plain_ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="plain"), sets, 5, keep=True)
        c["library_ms"] = time_ms(lambda x, h: F.layer_norm(
            x + F.dropout(h, p, training=True), (C,), gm, bt, 1e-5), sets,
            20, keep=True)
        c["bound_ms"], c["bound_by"] = bound(
            (2 * ix + ih) * rows * C + 8 * rows + 2 * C * ip, 10 * rows * C,
            dt)
        _, m, r = fb.residual_dropout_ln_fwd(c["x"], c["h"], gm, bt, key, p,
                                             impl="plain")
        bsets = input_sets([c["x"], c["h"], c["dy"]], 20)
        c["bwd_ms"] = time_ms(lambda x, h, dy: fb.residual_dropout_ln_bwd(
            x, h, dy, m, r, gm, key, p, impl="kernel"), bsets, 20)
        c["bwd_plain_ms"] = time_ms(
            lambda x, h, dy: fb.residual_dropout_ln_bwd(
                x, h, dy, m, r, gm, key, p, impl="plain"), bsets, 5)

        def lib(x, h, dy, backward=True):
            xl, hl = x.detach().requires_grad_(), h.detach().requires_grad_()
            gl, bl = gm.detach().requires_grad_(), bt.detach().requires_grad_()
            y = F.layer_norm(xl + F.dropout(hl, p, training=True), (C,), gl,
                             bl, 1e-5)
            if backward:
                torch.autograd.grad(y, (xl, hl, gl, bl), dy)

        c["bwd_library_ms"] = (time_ms(lib, bsets, 20) - time_ms(
            lambda *a: lib(*a, backward=False), bsets, 20))
        c["bwd_bound_ms"], c["bwd_bound_by"] = bound(
            (3 * ix + 2 * ih) * rows * C + 8 * rows + 3 * C * ip,
            16 * rows * C, dt)
        c["bwd_split"] = kernel_split_ms(
            torch, lambda x, h, dy: fb.residual_dropout_ln_bwd(
                x, h, dy, m, r, gm, key, p, impl="kernel"), bsets, 20)
        what = f"({rows}, {C}) {c['layout']} p={p}"
        log(f"[time] K3 {what} backward by kernel "
            f"(torch.profiler, a call): {_split_text(c['bwd_split'])}")
        log(f"[time] K3 {what}: forward kernel "
            f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, composed "
            f"F.dropout+add+F.layer_norm {c['library_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}), share "
            f"{c['bound_ms'] / c['ms']:.3f}; backward kernel "
            f"{c['bwd_ms']:.4f} ms, plain {c['bwd_plain_ms']:.4f} ms, "
            f"composed autograd {c['bwd_library_ms']:.4f} ms, bound "
            f"{c['bwd_bound_ms']:.4f} ms ({c['bwd_bound_by']}), share "
            f"{c['bwd_bound_ms'] / c['bwd_ms']:.3f}")

    for c in k4b:
        gm, m, r = c["gamma"], c["mean"], c["rstd"]
        rows, dt = c["rows"], _ops_dtype(c)
        ix, ip = c["x"].element_size(), gm.element_size()
        lib_fn, c["library"] = layer_norm_library(torch, c["x"], gm,
                                                  c["beta"])
        sets = input_sets([c["x"], c["dy"]], 20)
        c["ms"] = time_ms(lambda x, dy: ln.layer_norm_bwd(
            x, dy, m, r, gm, impl="kernel"), sets, 20)
        c["plain_ms"] = time_ms(lambda x, dy: ln.layer_norm_bwd(
            x, dy, m, r, gm, impl="plain"), sets, 5)

        def lib(x, dy, backward=True, c=c, lib_fn=lib_fn):
            xl = x.detach().requires_grad_()
            gl = c["gamma"].detach().requires_grad_()
            bl = c["beta"].detach().requires_grad_()
            y = lib_fn(xl, gl, bl)
            if backward:
                torch.autograd.grad(y, (xl, gl, bl), dy)

        c["library_ms"] = (time_ms(lib, sets, 20) - time_ms(
            lambda *a: lib(*a, backward=False), sets, 20))
        c["bound_ms"], c["bound_by"] = bound(
            3 * rows * C * ix + 8 * rows + 3 * C * ip, 12 * rows * C, dt)
        c["split"] = kernel_split_ms(torch, lambda x, dy: ln.layer_norm_bwd(
            x, dy, m, r, gm, impl="kernel"), sets, 20)
        what = f"({rows}, {C}) {c['layout']}"
        log(f"[time] K4b {what} by kernel (torch.profiler, a "
            f"call): {_split_text(c['split'])}")
        log(f"[time] K4b {what}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, {c['library']} backward "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), roofline share "
            f"{c['bound_ms'] / c['ms']:.3f}")

    for c in drop:
        key, p = c["key"], c["p"]
        sets = input_sets([c["x"]], 20)
        c["ms"] = time_ms(lambda x: dp.dropout_fwd(x, key, p, impl="kernel"),
                          sets, 20)
        c["plain_ms"] = time_ms(lambda x: dp.dropout_fwd(
            x, key, p, impl="plain"), sets, 5)
        c["library_ms"] = time_ms(lambda x: F.dropout(x, p, training=True),
                                  sets, 20)
        numel, item = c["x"].numel(), c["x"].element_size()
        c["bound_ms"], c["bound_by"] = bound(2 * numel * item, numel,
                                             _dt(c["dtype"]))
        log(f"[time] K5 ({ROWS}, {c['cols']}) {_dt(c['dtype'])}: kernel "
            f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, F.dropout "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), roofline share "
            f"{c['bound_ms'] / c['ms']:.3f}")


def gelu_dropout_cases(torch, dev):
    """K6 inputs, unit normal: the FFN hidden of the BERT-base step (8192,
    3072) in f32 and bf16 at p = 0.1 and p = 0 (the kernel without a
    mask); the site the reference sized its kernel for, BERT-base at
    sequence 512 (65536, 3072) bf16 (`ops/fused_block.py:261`); a ragged
    f32 shape for the scalar tail."""
    specs = [((ROWS, FFN), dt, p) for dt in (torch.float32, torch.bfloat16)
             for p in (TRAIN_P, 0.0)]
    specs += [(GD_LARGE, torch.bfloat16, TRAIN_P),
              (GD_RAGGED, torch.float32, TRAIN_P)]
    cases = []
    for shape, dtype, p in specs:
        g = torch.Generator(device=dev).manual_seed(shape[0] + shape[1])
        u = torch.randn(*shape, generator=g, device=dev).to(dtype)
        dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        cases.append(dict(u=u, dy=dy, shape=shape, dtype=dtype, p=p,
                          key=(1618033988, 2718281828)))
    return cases


def _gd_what(c):
    return f"{c['shape']} {_dt(c['dtype'])} p={c['p']}"


def phase_gelu_dropout_vs_plain(torch, dev):
    """K6 forward and backward against their plain versions; its zeros
    are the dropout kernel's (K5) mask for the same key, bit for bit."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    cases = gelu_dropout_cases(torch, dev)
    for c in cases:
        u, dy, key, p = c["u"], c["dy"], c["key"], c["p"]
        what = _gd_what(c)
        y = fb.gelu_dropout_fwd(u, key, p, impl="kernel")
        du = fb.gelu_dropout_bwd(u, dy, key, p, impl="kernel")
        yp = fb.gelu_dropout_fwd(u, key, p, impl="plain")
        dup = fb.gelu_dropout_bwd(u, dy, key, p, impl="plain")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all()
                   and torch.isfinite(du.float()).all()),
              f"K6 {what}: non-finite output")
        ok, err, rel = agree(y, yp, GD_TOL)
        _log_check("K6 fwd", what, y.dtype, ok, err, rel, GD_TOL)
        c["fwd_err"], c["fwd_rel"] = err, rel
        del yp
        ok, err, rel = agree(du, dup, GD_TOL)
        _log_check("K6 bwd", what, du.dtype, ok, err, rel, GD_TOL)
        c["bwd_err"], c["bwd_rel"] = err, rel
        del dup
        if p == 0:
            continue
        k5 = dp.dropout_fwd(torch.ones_like(u), key, p, impl="kernel") != 0
        gelu = fb.gelu_dropout_fwd(u, key, 0.0, impl="kernel")
        fwd_mask = torch.equal(y != 0, k5 & (gelu != 0))
        bwd_mask = not bool((du[~k5] != 0).any())
        log(f"[K6] {what}: forward zeros equal the dropout kernel's mask: "
            f"{fwd_mask}; backward zero wherever it drops: {bwd_mask}; "
            f"kept {k5.float().mean().item():.5f}")
        check(fwd_mask and bwd_mask, "K6 mask differs from K5's")
        if c["dtype"] == torch.float32:
            xla = dp.dropout_fwd(F.gelu(u, approximate="none"), key, p,
                                 impl="kernel")
            torch.cuda.synchronize()
            d = (y - xla).abs().max().item()
            log(f"[K6] {what}: against F.gelu then the dropout kernel (the "
                f"xla route): bit for bit {torch.equal(y, xla)}, max|d|="
                f"{d:.3e} (tol {GD_TOL:g})")
            check(d <= GD_TOL, "K6 disagrees with F.gelu + K5")
        del k5, gelu
    return cases


def gelu_errors(torch, dev, n):
    """Max abs error against float64 of gelu(u) = u * Phi(u) and gelu'(u)
    = Phi(u) + u * phi(u), at n float32 points u of [-10, 10]: K6 (p = 0,
    its rational normal tail) and the same formulas through erff and expf
    (PyTorch's exact F.gelu and its autograd, float32)."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    u = torch.linspace(-10, 10, n, device=dev)
    u64 = u.double()
    cdf = 0.5 * torch.special.erfc(-u64 / math.sqrt(2))
    pdf = torch.exp(-0.5 * u64 * u64) / math.sqrt(2 * math.pi)
    ref = {"gelu": u64 * cdf, "gelu'": cdf + u64 * pdf}
    ones = torch.ones_like(u)
    k6 = {"gelu": fb.gelu_dropout_fwd(u, (0, 0), 0.0, impl="kernel"),
          "gelu'": fb.gelu_dropout_bwd(u, ones, (0, 0), 0.0, impl="kernel")}
    leaf = u.clone().requires_grad_()
    y = F.gelu(leaf, approximate="none")
    (dy,) = torch.autograd.grad(y, leaf, ones)
    erff = {"gelu": y.detach(), "gelu'": dy}
    return {name: ((k6[name].double() - r).abs().max().item(),
                   (erff[name].double() - r).abs().max().item())
            for name, r in ref.items()}


def phase_gelu_accuracy(torch, dev):
    """K6's normal tail is as accurate as erff's form: its max abs error
    of gelu and gelu' against float64 is no larger."""
    errs = gelu_errors(torch, dev, GD_SWEEP)
    for name, (k6, erff) in errs.items():
        log(f"[K6] {name} on {GD_SWEEP} points of [-10, 10], max abs error "
            f"against float64: K6 {k6:.4e}, through erff (F.gelu) "
            f"{erff:.4e}: {'ok' if k6 <= erff else 'LARGER'}")
        check(k6 <= erff, f"K6's {name} is less accurate than erff's form")
    return errs


def phase_gelu_dropout_path(torch, dev):
    """The slice's path at full width: Dense(3072) -> npx.gelu_dropout ->
    Dense(768) on (64, 128, 768), forward and backward, on the kernels
    ("auto"), on the plain versions and on the reference's composition
    ("xla"): same weights, same key, launches counted per step."""
    from incubator_mxnet_tpu_torch import npx
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon import nn

    g = torch.Generator(device=dev).manual_seed(31)
    d1 = nn.Dense(FFN, in_units=C, flatten=False, device=dev)
    d2 = nn.Dense(C, in_units=FFN, flatten=False, device=dev)
    for layer in (d1, d2):
        layer.reset_parameters(generator=g)
        with torch.no_grad():
            layer.bias.normal_(0, 0.1, generator=g)
    params = [d1.weight, d1.bias, d2.weight, d2.bias]
    names = ["x", "dense1.weight", "dense1.bias", "dense2.weight",
             "dense2.bias"]
    x = torch.randn(TRAIN_B, TRAIN_T, C, generator=g, device=dev)
    gy = torch.randn(TRAIN_B, TRAIN_T, C, generator=g, device=dev)

    def step(impl):
        for prm in params:
            prm.grad = None
        xl = x.detach().requires_grad_()
        mxrandom.seed(77)
        y = d2(npx.gelu_dropout(d1(xl), p=TRAIN_P, training=True,
                                impl=impl))
        (y * gy).sum().backward()
        return [y.detach(), xl.grad] + [prm.grad for prm in params]

    runs = {}
    for impl in ("auto", "plain", "xla"):
        for _ in range(GD_WARMUP):
            step(impl)
        torch.cuda.synchronize()
        walls, counts = [], []
        for _ in range(GD_STEPS):
            reset_counts()
            start = time.perf_counter()
            out = step(impl)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - start) * 1e3)
            counts.append(read_counts())
        runs[impl] = dict(out=out, walls=walls, counts=counts)
    zero = {k: 0 for k in STEP_LAUNCHES}
    expect = {"auto": dict(zero, K6f=1, K6b=1), "plain": zero,
              "xla": dict(zero, K5=2)}
    for impl, r in runs.items():
        log(f"[gelu_dropout] {impl}: launches per step {r['counts'][0]}; "
            f"step ms " + ", ".join(f"{t:.2f}" for t in r["walls"]))
        check(all(cn == expect[impl] for cn in r["counts"]),
              f"gelu_dropout path ({impl}): launches {r['counts']}, "
              f"expected {expect[impl]} every step")
    worst = {}
    for other in ("plain", "xla"):
        w = 0.0
        for name, got, ref in zip(["y"] + names, runs["auto"]["out"],
                                  runs[other]["out"]):
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"gelu_dropout path: {name} malformed")
            scale = ref.abs().max().item()
            w = max(w, (got - ref).abs().max().item() / max(scale, 1e-30))
        worst[other] = w
        log(f"[gelu_dropout] auto vs {other}: y and the gradients of x and "
            f"both Dense layers, worst max|d| / max|{other}| {w:.2e} "
            f"(tol {GD_PATH_REL_TOL:g})")
        check(w <= GD_PATH_REL_TOL,
              f"gelu_dropout path disagrees with {other}")

    def med(v):
        v = sorted(v)
        return v[len(v) // 2]

    launches = {"K6f": sum(cn["K6f"] for cn in runs["auto"]["counts"]),
                "K6b": sum(cn["K6b"] for cn in runs["auto"]["counts"])}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step("auto")
        torch.cuda.synchronize()
    dev_ms = _device_ms(prof)
    k6_ms = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "gelu_dropout" in e.key) / 1e3
    result = dict(batch=TRAIN_B, seq=TRAIN_T, units=C, hidden=FFN, p=TRAIN_P,
                  steps=GD_STEPS,
                  **{f"{k}_step_ms": r["walls"] for k, r in runs.items()},
                  **{f"{k}_median_step_ms": med(r["walls"])
                     for k, r in runs.items()},
                  launches_per_step={k: r["counts"][0]
                                     for k, r in runs.items()},
                  worst_rel_err_vs_plain=worst["plain"],
                  worst_rel_err_vs_xla=worst["xla"],
                  device_ms_per_step=dev_ms, k6_device_ms_per_step=k6_ms)
    auto_ms = result["auto_median_step_ms"]
    result["idle_share"] = 1 - dev_ms / auto_ms if dev_ms > 0 else None
    log(f"[gelu_dropout] median step ms: auto (K6) {auto_ms:.3f}, xla "
        f"(F.gelu + K5) {result['xla_median_step_ms']:.3f}, plain "
        f"{result['plain_median_step_ms']:.3f}; one auto step's device "
        f"time (torch.profiler) {dev_ms:.3f} ms, of which K6 {k6_ms:.3f} "
        f"ms -> idle share "
        + (f"{result['idle_share']:.4f}" if dev_ms > 0 else "not measured"))
    return result, launches


def phase_times_gelu_dropout(torch, cases):
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    for c in cases:
        key, p = c["key"], c["p"]
        numel, item = c["u"].numel(), c["u"].element_size()

        def lib(u, dy=None, c=c):
            leaf = u.detach().requires_grad_(dy is not None)
            out = F.gelu(leaf, approximate="none")
            if c["p"] > 0:
                out = F.dropout(out, c["p"], training=True)
            if dy is not None:
                torch.autograd.grad(out, leaf, dy)

        def xla(u, dy=None, c=c):
            leaf = u.detach().requires_grad_(dy is not None)
            out = dp.dropout(F.gelu(leaf, approximate="none"), c["key"],
                             c["p"], impl="kernel")
            if dy is not None:
                torch.autograd.grad(out, leaf, dy)

        sets = input_sets([c["u"]], 20)
        c["ms"] = time_ms(lambda u: fb.gelu_dropout_fwd(u, key, p,
                                                        impl="kernel"),
                          sets, 20)
        c["plain_ms"] = time_ms(lambda u: fb.gelu_dropout_fwd(
            u, key, p, impl="plain"), sets, 3)
        c["library_ms"] = time_ms(lib, sets, 20)
        c["xla_ms"] = time_ms(xla, sets, 20)
        c["bound_ms"], c["bound_by"] = bound(2 * numel * item,
                                             GD_FWD_OPS * numel, "float32")
        bsets = input_sets([c["u"], c["dy"]], 20)
        c["bwd_ms"] = time_ms(lambda u, dy: fb.gelu_dropout_bwd(
            u, dy, key, p, impl="kernel"), bsets, 20)
        c["bwd_plain_ms"] = time_ms(lambda u, dy: fb.gelu_dropout_bwd(
            u, dy, key, p, impl="plain"), bsets, 3)
        c["bwd_library_ms"] = (time_ms(lib, bsets, 20)
                               - time_ms(lambda u, _: lib(u), bsets, 20))
        c["bwd_xla_ms"] = (time_ms(xla, bsets, 20)
                           - time_ms(lambda u, _: xla(u), bsets, 20))
        c["bwd_bound_ms"], c["bwd_bound_by"] = bound(
            3 * numel * item, GD_BWD_OPS * numel, "float32")
        log(f"[time] K6 {_gd_what(c)}: forward kernel {c['ms']:.4f} ms, "
            f"plain {c['plain_ms']:.4f} ms, F.dropout(F.gelu) "
            f"{c['library_ms']:.4f} ms, F.gelu + K5 {c['xla_ms']:.4f} ms, "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}), share "
            f"{c['bound_ms'] / c['ms']:.3f}; backward kernel "
            f"{c['bwd_ms']:.4f} ms, plain {c['bwd_plain_ms']:.4f} ms, "
            f"autograd of F.dropout(F.gelu) {c['bwd_library_ms']:.4f} ms, of "
            f"F.gelu + K5 {c['bwd_xla_ms']:.4f} ms, bound "
            f"{c['bwd_bound_ms']:.4f} ms ({c['bwd_bound_by']}), share "
            f"{c['bwd_bound_ms'] / c['bwd_ms']:.3f}")


# ---------------------------------------------------------------------------
# [nd]: the reference's imperative path (NDArray, mx.np/npx, autograd)
# ---------------------------------------------------------------------------

# bench.py's bench_dot_pair: chained (1024, 1024) f32 dots, one scalar fetch
ND_DOT_N, ND_DOT_ITERS, ND_DOT_WARMUP, ND_DOT_ROUNDS = 1024, 100, 10, 3
ND_HOST_CALLS = 1000
ND_WARMUP, ND_STEPS, ND_SEED = 1, 5, 123
# the NDArray path against the module path on the same weights and keys,
# f32: output and every gradient, max|d| / max|module path|
ND_TOL = 1e-6
# the same under AMP: normwise relative, tests/test_torch_amp.py's
# SCORE_TOL
ND_AMP_TOL = 2.0 ** -5
# launches of one NDArray step (forward and backward) of the layer at
# p = 0.1: K5 at the embedding, the attention output and the FFN hidden,
# both ways; a K2 call is 3 kernels, a K4b or K3 backward call 2
ND_LAUNCHES = {"K1": 1, "K2": 3, "K4": 1, "K4b": 2, "K3f": 2, "K3b": 4,
               "K5": 6, "K6f": 0, "K6b": 0, "fold": 0}
# the card's result of the autograd semantics against the CPU's
ND_SEM_TOL = 1e-5


def nd_encoder_layer(mx, P, tokens, token_types, valid_length, p, heads):
    """BERT's embedding sum, LayerNorm (K4), dropout (K5) and one post-LN
    encoder layer as the reference's `models/bert.py` computes it
    (`MultiHeadAttention` :72-90 in "bthd" with ``valid_length``, K1;
    `PositionwiseFFN` :133; the residual sites :164 and :169, K3),
    composed of ``mx.np``/``mx.npx`` calls on the NDArrays of ``P``,
    which are named as the port's `BERTEncoder` parameters. ``mx`` is
    either package: the CPU tests run it on the reference too."""
    npx = mx.npx
    x = npx.embedding(tokens, P["word_embed.weight"]) + npx.embedding(
        token_types, P["token_type_embed.weight"])
    x = npx.layer_norm(x + P["position_embed"][:tokens.shape[1]],
                       P["ln.gamma"], P["ln.beta"])
    x = npx.dropout(x, p=p)
    n, t, c = x.shape
    d = c // heads
    cell = "layers.0."

    def dense(h, name):
        w = P[cell + name + ".weight"]
        return npx.fully_connected(h, w, P[cell + name + ".bias"],
                                   num_hidden=w.shape[0], flatten=False)

    qkv = dense(x, "attention.qkv")
    q = qkv[..., :c].reshape(n, t, heads, d)
    k = qkv[..., c:2 * c].reshape(n, t, heads, d)
    v = qkv[..., 2 * c:].reshape(n, t, heads, d)
    out = npx.flash_attention(q, k, v, valid_length=valid_length,
                              layout="bthd")
    out = npx.dropout(out.reshape(n, t, c), p=p)
    x = npx.residual_dropout_ln(x, dense(out, "attention.proj"),
                                P[cell + "ln1.gamma"], P[cell + "ln1.beta"],
                                p=p)
    h = npx.activation(dense(x, "ffn.ffn1"), act_type="gelu")
    h = npx.dropout(h, p=p)
    return npx.residual_dropout_ln(x, dense(h, "ffn.ffn2"),
                                   P[cell + "ln2.gamma"],
                                   P[cell + "ln2.beta"], p=p)


def _nd_dot_chain(torch, fn, a, b, iters, warmup):
    """(ms an op, host us an op) of ``iters`` chained ``fn(acc, b)`` after
    ``warmup``, synced by one scalar fetch (bench.py:128)."""
    acc = a
    for _ in range(warmup):
        acc = fn(acc, b)
    float(acc[0, 0])
    start = time.perf_counter()
    for _ in range(iters):
        acc = fn(acc, b)
    host = time.perf_counter() - start
    float(acc[0, 0])
    wall = time.perf_counter() - start
    return wall / iters * 1e3, host / iters * 1e6


def phase_nd_dot(torch, mx):
    """bench.py's bench_dot_pair on the card: ``mx.np.dot`` through the
    funnel against ``torch.matmul`` on the same tensors, interleaved
    rounds, the median of the rounds' ratios."""
    import numpy as onp

    rng = onp.random.RandomState(0)
    a = mx.np.array(rng.uniform(-1, 1, (ND_DOT_N, ND_DOT_N))
                    .astype("float32"))
    b = mx.np.array((rng.uniform(-1, 1, (ND_DOT_N, ND_DOT_N)) / ND_DOT_N)
                    .astype("float32"))
    check(a._data.is_cuda and b._data.is_cuda, "[nd] arrays not on the card")
    fw, raw, ratios = [], [], []
    for _ in range(ND_DOT_ROUNDS):
        f = _nd_dot_chain(torch, mx.np.dot, a, b, ND_DOT_ITERS,
                          ND_DOT_WARMUP)
        r = _nd_dot_chain(torch, torch.matmul, a._data, b._data,
                          ND_DOT_ITERS, ND_DOT_WARMUP)
        fw.append(f)
        raw.append(r)
        ratios.append(f[0] / r[0])
    out = mx.np.dot(a, b)
    ref = torch.matmul(a._data, b._data)
    check(torch.equal(out._data, ref), "[nd] np.dot is not torch.matmul")
    res = dict(n=ND_DOT_N, iters=ND_DOT_ITERS, rounds=ND_DOT_ROUNDS,
               np_dot_ms_per_op=min(x[0] for x in fw),
               matmul_ms_per_op=min(x[0] for x in raw),
               np_dot_host_us_per_op=min(x[1] for x in fw),
               matmul_host_us_per_op=min(x[1] for x in raw),
               ratio_median=sorted(ratios)[len(ratios) // 2],
               ratios=ratios,
               bound_ms=bound(3 * ND_DOT_N ** 2 * 4, 2 * ND_DOT_N ** 3,
                              "float32")[0])
    log(f"[nd] dot {ND_DOT_N}^2 f32 x {ND_DOT_ITERS} chained, "
        f"{ND_DOT_ROUNDS} rounds: mx.np.dot {res['np_dot_ms_per_op']:.4f} "
        f"ms an op (host {res['np_dot_host_us_per_op']:.1f} us), "
        f"torch.matmul {res['matmul_ms_per_op']:.4f} ms "
        f"(host {res['matmul_host_us_per_op']:.1f} us), ratio median "
        f"{res['ratio_median']:.4f} (rounds "
        + ", ".join(f"{x:.4f}" for x in ratios)
        + f"); bound {res['bound_ms']:.4f} ms")
    return res


def phase_nd_host(torch, mx):
    """The funnel's host time an op: ``x + y`` on (8,) NDArrays on the
    card, ND_HOST_CALLS calls, against ``torch.add`` on their tensors,
    outside and inside ``autograd.record()`` (x with a gradient buffer)."""
    x = mx.np.ones((8,))
    y = mx.np.ones((8,))

    def per_call_us(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(ND_HOST_CALLS):
            fn()
        us = (time.perf_counter() - start) / ND_HOST_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    res = dict(nd_add_us=per_call_us(lambda: x + y),
               torch_add_us=per_call_us(lambda: torch.add(x._data,
                                                          y._data)))
    x.attach_grad()
    with mx.autograd.record():
        res["nd_add_recorded_us"] = per_call_us(lambda: x + y)
    xt = x._data
    res["torch_add_recorded_us"] = per_call_us(lambda: torch.add(xt,
                                                                 y._data))
    res["funnel_us"] = res["nd_add_us"] - res["torch_add_us"]
    log(f"[nd] host us a call, (8,) f32 on the card: x + y "
        f"{res['nd_add_us']:.2f} (torch.add {res['torch_add_us']:.2f}: "
        f"the funnel {res['funnel_us']:.2f}); recorded "
        f"{res['nd_add_recorded_us']:.2f} (torch.add with grad "
        f"{res['torch_add_recorded_us']:.2f})")
    return res


def _nd_rel(got, ref):
    """max|d| / max|ref| and normwise relative error, in float64."""
    g, r = got.double(), ref.double()
    d = (g - r).abs()
    return (d.max().item() / max(r.abs().max().item(), 1e-30),
            (d.norm() / r.norm().clamp_min(1e-30)).item())


def phase_nd_bert(torch, dev, mx):
    """BERT-base's embedding and one encoder layer at 64 x 128 through
    NDArrays under ``autograd.record()`` and ``.backward()``, against the
    same computation through the port's `nn.Module` path on the same
    weights (a seeded `BERTModel`'s): at p = 0 and at p = 0.1 with the same
    keys drawn in the same order, f32 and under AMP; launches counted by
    the wrappers; a second ``backward`` over the same graph."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ndarray import ndarray as ndmod

    model = BERTModel(num_layers=1, max_length=TRAIN_T, dropout=TRAIN_P,
                      device=dev, seed=0)
    enc = model.encoder
    named = dict(enc.named_parameters())
    P = {n: mx.nd.array(prm.detach().clone()) for n, prm in named.items()}
    for arr in P.values():
        arr.attach_grad()
    g = torch.Generator(device=dev).manual_seed(17)
    tok = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                        device=dev)
    typ = torch.randint(0, 2, (TRAIN_B, TRAIN_T), generator=g, device=dev)
    vl = torch.randint(TRAIN_T // 2, TRAIN_T + 1, (TRAIN_B,), generator=g,
                       device=dev)
    gy = torch.randn(TRAIN_B, TRAIN_T, C, generator=g, device=dev)
    tok_nd, typ_nd, vl_nd, gy_nd = (mx.nd.array(t) for t in
                                    (tok, typ, vl, gy))
    keys = []
    draw = mxrandom.next_key

    def recording_draw():
        k = draw()
        keys.append(k)
        return k

    ops = [0]
    finish = ndmod._finish

    def counting_finish(*a, **kw):
        ops[0] += 1
        return finish(*a, **kw)

    def nd_step(p, twice=False):
        mxrandom.seed(ND_SEED)
        with mx.autograd.record():
            out = nd_encoder_layer(mx, P, tok_nd, typ_nd, vl_nd, p, H)
            loss = (out * gy_nd).sum()
        loss.backward()
        grads = {n: a.grad._data for n, a in P.items()}
        if twice:
            loss.backward()
            return out._data, grads, {n: a.grad._data for n, a in P.items()}
        return out._data, grads

    def module_step(p):
        enc.train(p > 0)
        enc.zero_grad(set_to_none=True)
        mxrandom.seed(ND_SEED)
        out = enc(tok, typ, vl)
        (out * gy).sum().backward()
        return out.detach(), {n: prm.grad for n, prm in named.items()}

    def timed(step, p):
        for _ in range(ND_WARMUP):
            step(p)
        torch.cuda.synchronize()
        walls, counts, layouts = [], [], []
        for _ in range(ND_STEPS):
            reset_counts()
            start = time.perf_counter()
            out = step(p)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - start) * 1e3)
            counts.append(read_counts())
            layouts.append(read_layout_counts())
        return out, walls, counts, layouts

    def med(v):
        return sorted(v)[len(v) // 2]

    res, launches, by_layout = {}, {}, {}

    def add_launches(counts, layouts):
        for cn in counts:
            for k, n in cn.items():
                launches[k] = launches.get(k, 0) + n
        for lay in layouts:
            for k, v in lay.items():
                for name, n in v.items():
                    by_layout.setdefault(k, {})
                    by_layout[k][name] = by_layout[k].get(name, 0) + n

    for mode in ("f32", "amp"):
        if mode == "amp":
            amp.init("bfloat16")
        try:
            for p in ((0.0, TRAIN_P) if mode == "f32" else (TRAIN_P,)):
                tag = f"{mode} p={p:g}"
                mxrandom.next_key = recording_draw
                ndmod._finish = counting_finish
                try:
                    keys.clear()
                    ops[0] = 0
                    (o_nd, g_nd), w_nd, c_nd, l_nd = timed(nd_step, p)
                    nd_keys, nd_ops = list(keys), ops[0]
                    ndmod._finish = finish
                    keys.clear()
                    (o_mod, g_mod), w_mod, c_mod, l_mod = timed(module_step,
                                                                p)
                    mod_keys = list(keys)
                finally:
                    mxrandom.next_key = draw
                    ndmod._finish = finish
                add_launches(c_nd, l_nd)
                steps = ND_WARMUP + ND_STEPS
                check(o_nd.shape == (TRAIN_B, TRAIN_T, C)
                      and bool(torch.isfinite(o_nd.float()).all()),
                      f"[nd] {tag}: output malformed")
                check(nd_keys == mod_keys and len(nd_keys) ==
                      steps * (5 if p > 0 else 0),
                      f"[nd] {tag}: keys {len(nd_keys)} drawn, module path "
                      f"{len(mod_keys)}, or not the same")
                check(all(cn == c_mod[0] for cn in c_nd + c_mod),
                      f"[nd] {tag}: launches {c_nd} vs module {c_mod}")
                check(all(lay == l_mod[0] for lay in l_nd + l_mod),
                      f"[nd] {tag}: launches by layout {l_nd} vs module "
                      f"{l_mod}")
                if mode == "f32" and p > 0:
                    check(c_nd[0] == ND_LAUNCHES,
                          f"[nd] {tag}: launches {c_nd[0]}, expected "
                          f"{ND_LAUNCHES}")
                check(all(c_nd[0][k] > 0 for k in ("K1", "K2", "K3f",
                                                     "K3b", "K4", "K4b"))
                      and (p == 0 or c_nd[0]["K5"] > 0),
                      f"[nd] {tag}: a kernel did not launch: {c_nd[0]}")
                errs = {"out": _nd_rel(o_nd, o_mod)}
                for n in named:
                    check(g_nd[n] is not None and g_mod[n] is not None,
                          f"[nd] {tag}: no gradient for {n}")
                    errs[n] = _nd_rel(g_nd[n], g_mod[n])
                bitwise = torch.equal(o_nd, o_mod) and all(
                    torch.equal(g_nd[n], g_mod[n]) for n in named)
                worst = max(e[1 if mode == "amp" else 0]
                            for e in errs.values())
                tol = ND_AMP_TOL if mode == "amp" else ND_TOL
                log(f"[nd] BERT-base embedding + 1 layer {TRAIN_B} x "
                    f"{TRAIN_T}, {tag}: NDArray path vs module path, "
                    f"output and {len(named)} gradients: worst "
                    + ("normwise rel" if mode == "amp" else
                       "max|d|/max|module|")
                    + f" {worst:.3e} (tol {tol:g}), bitwise equal "
                    f"{bitwise}; keys drawn {len(nd_keys)} (equal); "
                    f"launches a step {c_nd[0]}; funnel calls a step "
                    f"{nd_ops // steps}; step wall ms median NDArray "
                    f"{med(w_nd):.3f}, module {med(w_mod):.3f} (NDArray "
                    + ", ".join(f"{w:.2f}" for w in w_nd) + "; module "
                    + ", ".join(f"{w:.2f}" for w in w_mod) + ")")
                check(worst <= tol, f"[nd] {tag}: NDArray path disagrees "
                      f"with the module path: {worst:.3e}")
                # the same ops, kernels, layouts, order and keys: the same
                # bits (an AMP cast the funnel skipped shows here, far
                # under the tolerance above)
                check(bitwise, f"[nd] {tag}: NDArray path not bit for bit "
                      f"the module path's")
                res[tag] = dict(worst_err=worst, tol=tol, bitwise=bitwise,
                                keys=len(nd_keys), launches=c_nd[0],
                                funnel_calls_per_step=nd_ops // steps,
                                nd_step_ms=w_nd, module_step_ms=w_mod,
                                nd_median_step_ms=med(w_nd),
                                module_median_step_ms=med(w_mod))
        finally:
            if mode == "amp":
                amp.deinit()
    # a second backward over the same graph: the same gradients
    reset_counts()
    _, first, second = nd_step(TRAIN_P, twice=True)
    torch.cuda.synchronize()
    cn = read_counts()
    add_launches([cn], [read_layout_counts()])
    same = all(torch.equal(first[n], second[n]) for n in first)
    log(f"[nd] backward twice over one graph (p={TRAIN_P:g}): every "
        f"gradient bit for bit the same {same}; launches {cn}")
    check(same, "[nd] a second backward gave other gradients")
    check(cn["K2"] == 2 * ND_LAUNCHES["K2"] and cn["K5"] ==
          ND_LAUNCHES["K5"] + ND_LAUNCHES["K5"] // 2,
          f"[nd] backward twice: launches {cn}")
    res["backward_twice_equal"] = same
    del model, enc, P
    return res, launches, by_layout


def phase_nd_gelu_dropout(torch, mx):
    """K6 through NDArrays: ``npx.gelu_dropout(nd, p=0.1, impl="pallas")``
    on (8192, 3072) under ``record()``, then ``.backward()``, against the
    torch-tensor call with the same key: output and gradient equal."""
    from incubator_mxnet_tpu_torch import npx
    from incubator_mxnet_tpu_torch import random as mxrandom

    g = torch.Generator(device="cuda").manual_seed(41)
    res, launches = {}, {"K6f": 0, "K6b": 0}
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.randn(ROWS, FFN, generator=g, device="cuda").to(dtype)
        x = mx.nd.array(u.clone())
        x.attach_grad()
        mxrandom.seed(ND_SEED)
        reset_counts()
        with mx.autograd.record():
            y = npx.gelu_dropout(x, p=TRAIN_P, impl="pallas")
        y.backward()
        torch.cuda.synchronize()
        cn = read_counts()
        launches["K6f"] += cn["K6f"]
        launches["K6b"] += cn["K6b"]
        ut = u.clone().requires_grad_()
        mxrandom.seed(ND_SEED)
        yt = npx.gelu_dropout(ut, p=TRAIN_P, impl="pallas", training=True)
        yt.backward(torch.ones_like(yt))
        same = torch.equal(y._data, yt.detach()) and torch.equal(
            x.grad._data, ut.grad)
        name = _dt(dtype)
        log(f"[nd] K6 through NDArrays ({ROWS}, {FFN}) {name} p={TRAIN_P:g}:"
            f" launches {cn['K6f']} forward, {cn['K6b']} backward; output "
            f"and gradient bit for bit the torch-tensor call's {same}")
        check(cn["K6f"] == 1 and cn["K6b"] == 1,
              f"[nd] K6 {name}: launches {cn}")
        check(same, f"[nd] K6 {name}: NDArray path differs")
        res[name] = dict(equal=same, launches=cn["K6f"] + cn["K6b"])
    return res, launches


def _nd_semantics(mx, np_seed=4):
    """The autograd semantics the reference has and torch does not give by
    itself, on the current device: {name: [numpy arrays]}."""
    import numpy as onp

    np, ag = mx.np, mx.autograd
    rng = onp.random.RandomState(np_seed)
    x0 = rng.uniform(-1, 1, (4, 6)).astype("float32")
    w0 = rng.uniform(-1, 1, (6, 3)).astype("float32")
    out = {}
    x, w = np.array(x0), np.array(w0)
    x.attach_grad()
    w.attach_grad()
    with ag.record():
        y = np.tanh(np.dot(x, w)).sum()
    y.backward()
    first = [x.grad.asnumpy(), w.grad.asnumpy()]
    y.backward()
    out["backward_twice"] = first + [x.grad.asnumpy(), w.grad.asnumpy()]
    x = np.array(x0)
    x.attach_grad(grad_req="add")
    with ag.record():
        y = (np.exp(x) * x).sum()
    y.backward()
    once = x.grad.asnumpy()
    y.backward()
    out["grad_req_add"] = [once, x.grad.asnumpy()]
    x = np.array(x0)
    x.attach_grad()
    with ag.record():
        y = (x ** 3).sum()
        (dx,) = ag.grad([y], [x], create_graph=True)
        s = dx.sum()
    s.backward()
    out["create_graph"] = [dx.asnumpy(), x.grad.asnumpy()]

    class Sigmoid(ag.Function):
        def forward(self, a):
            b = 1.0 / (1.0 + np.exp(-a))
            self.save_for_backward(b)
            return b

        def backward(self, dy):
            (b,) = self.saved_tensors
            return dy * b * (1.0 - b)

    x = np.array(x0)
    x.attach_grad()
    with ag.record():
        y = Sigmoid()(x)
        z = (y * y).sum()
    z.backward()
    out["function"] = [y.asnumpy(), x.grad.asnumpy()]
    return out, x0


def phase_nd_semantics(torch, mx):  # noqa: ARG001
    """The autograd semantics on the card against the same port code on
    the CPU, and against their closed forms."""
    import numpy as onp

    card, x0 = _nd_semantics(mx)
    with mx.cpu():
        cpu, _ = _nd_semantics(mx)
    worst = 0.0
    for name, arrays in card.items():
        for a, b in zip(arrays, cpu[name]):
            check(a.shape == b.shape and onp.isfinite(a).all(),
                  f"[nd] semantics {name}: malformed")
            worst = max(worst, float(onp.abs(a - b).max()
                                     / max(onp.abs(b).max(), 1e-30)))
    bt = card["backward_twice"]
    ok_twice = onp.array_equal(bt[0], bt[2]) and onp.array_equal(bt[1], bt[3])
    add = card["grad_req_add"]
    ok_add = onp.allclose(add[1], 2 * add[0], rtol=ND_SEM_TOL)
    cg = card["create_graph"]
    ok_cg = onp.allclose(cg[0], 3 * x0 ** 2, rtol=ND_SEM_TOL,
                         atol=ND_SEM_TOL) and onp.allclose(
        cg[1], 6 * x0, rtol=ND_SEM_TOL, atol=ND_SEM_TOL)
    sig = 1 / (1 + onp.exp(-x0.astype("float64")))
    fn = card["function"]
    ok_fn = onp.allclose(fn[1], 2 * sig * sig * (1 - sig), rtol=1e-4,
                         atol=1e-6)
    log(f"[nd] semantics on the card vs the CPU: worst max|d|/max|cpu| "
        f"{worst:.2e} (tol {ND_SEM_TOL:g}); backward twice equal {ok_twice},"
        f" grad_req='add' doubles {ok_add}, grad(create_graph=True) "
        f"3x^2 and 6x {ok_cg}, custom Function's gradient {ok_fn}")
    check(worst <= ND_SEM_TOL and ok_twice and ok_add and ok_cg and ok_fn,
          "[nd] autograd semantics on the card")
    return dict(worst_vs_cpu=worst, backward_twice=ok_twice,
                grad_req_add=ok_add, create_graph=ok_cg, function=ok_fn)


def phase_nd(torch, dev):
    """[nd]: the reference's imperative front door on the card, NDArray
    creation on ``cuda:0`` by default (no scope open)."""
    import incubator_mxnet_tpu_torch as mx

    check(mx.current_device() == mx.gpu(0)
          and mx.np.zeros((1,))._data.device == dev,
          "[nd] NDArray creation does not target cuda:0 by default")
    start = time.perf_counter()
    res = {"dot": phase_nd_dot(torch, mx), "host": phase_nd_host(torch, mx)}
    res["bert"], launches, by_layout = phase_nd_bert(torch, dev, mx)
    torch.cuda.empty_cache()
    res["gelu_dropout"], gd = phase_nd_gelu_dropout(torch, mx)
    for k, n in gd.items():
        launches[k] = launches.get(k, 0) + n
    res["semantics"] = phase_nd_semantics(torch, mx)
    mx.waitall()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - start
    log(f"[nd] launches through NDArrays: {launches}; {res['seconds']:.1f} s")
    return res, launches, by_layout


def _case_row(c, shape):
    """A case's entry in the kernels line; ``dtype`` names a mixed
    layout ("f32 x, bf16 h, f32 gamma") where it has one."""
    layout = c.get("layout", "")
    row = dict(shape=shape,
               dtype=_dt(c["dtype"]) if layout in ("", "f32", "bf16")
               else layout,
               max_abs_err=c["max_abs_err"],
               norm_rel_err=c["norm_rel_err"], ms=c["ms"],
               plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
               bound_by=c["bound_by"], library_ms=c["library_ms"])
    if "xla_ms" in c:
        row["xla_ms"] = c["xla_ms"]
    if "split" in c:
        row["ms_by_kernel"] = c["split"]
    if "library" in c:
        row["library"] = c["library"]
    for k in ("blocks", "warm_ms", "library_warm_ms", "floor_ms",
              "host_us_a_call"):
        if k in c:
            row[k] = c[k]
    return row


def _pass_view(c, bwd):
    """A K3 or K6 case's forward or backward numbers under the common
    keys."""
    pre = "bwd_" if bwd else ""
    return dict(dtype=c["dtype"], layout=c.get("layout", ""),
                max_abs_err=c["bwd_err" if bwd else
                                                 "fwd_err"],
                norm_rel_err=c["bwd_rel" if bwd else "fwd_rel"],
                ms=c[pre + "ms"], plain_ms=c[pre + "plain_ms"],
                bound_ms=c[pre + "bound_ms"], bound_by=c[pre + "bound_by"],
                library_ms=c[pre + "library_ms"], p=c["p"],
                **({"xla_ms": c[pre + "xla_ms"]} if pre + "xla_ms" in c
                   else {}),
                **({"split": c["bwd_split"]} if bwd and "bwd_split" in c
                   else {}))


def kernels_line(attn, lns, launches, train=None, gd=None, by_layout=None,
                 fold=None):
    """The kernels' entries; ``train`` = (attn, k3, k4b, drop) of the
    training kernels' cases, ``gd`` the K6 cases, ``by_layout`` the row
    kernels' main-path launches by layout (K4, K4b, K3f, K3b), ``fold``
    the fold kernel's case (it replaces no Pallas kernel: the reference
    folds its step's key with `jax.random.fold_in`)."""
    by_layout = by_layout or {}

    def entry(name, source, replaces, n, cases, main, library, key=None):
        out = dict(name=name, route="cuda", source=source,
                   replaces=replaces, launches=n,
                   max_abs_err=max(c["max_abs_err"] for c, _ in cases),
                   ms=main["ms"], plain_ms=main["plain_ms"],
                   bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                   library_ms=main["library_ms"], shape=main["shape"],
                   dtype=main["dtype"], library=library,
                   cases=[_case_row(c, s) for c, s in cases])
        if key in by_layout:
            out["launches_by_layout"] = by_layout[key]
        return out

    a_cases = [(c, f"N={c['n']} H={H} T={c['t']} d={D} "
                + ("lengths bhtd" if c["lengths"] is not None
                   else "causal bthd" if c["causal"] else "bthd"))
               for c in attn]
    l_cases = [(c, f"({c['rows']}, {C})") for c in lns]
    # headline shape: the f32 prefill of the largest prompt
    a_main = _case_row(*next((c, s) for c, s in a_cases
                             if c["t"] == ATTN_T[-1] and c["n"] == N
                             and _dt(c["dtype"]) == "float32"))
    l_main = _case_row(*next((c, s) for c, s in l_cases
                             if c["rows"] == N * ATTN_T[-1] and _dt(c["dtype"])
                             == "float32"))
    src = "incubator_mxnet_tpu_torch/csrc/"
    ref = "incubator_mxnet_tpu/ops/"
    out = [
        entry("flash_attention_fwd", src + "flash_attention.cu",
              ref + "flash_attention.py:122", launches["K1"], a_cases,
              a_main, "torch.nn.functional.scaled_dot_product_attention"),
        entry("layer_norm_fwd", src + "layer_norm.cu",
              ref + "layer_norm.py:63", launches["K4"], l_cases, l_main,
              "torch.nn.functional.layer_norm", "K4"),
    ]
    if train is None:
        return {"kernels": out}
    t_attn, k3, k4b, drop = train

    def first(cases, pred):
        return _case_row(*next((c, s) for c, s in cases if pred(c)))

    def f32(c):
        return _dt(c["dtype"]) == "float32"

    b_cases = [(c, f"B={c['b']} H={H} T={c['t']} d={D} bthd"
                + (" causal" if c["causal"] else "")
                + (" lengths" if c["lengths"] is not None else ""))
               for c in t_attn]
    f_cases = [(_pass_view(c, False), f"({c['rows']}, {C}) p={c['p']}")
               for c in k3]
    g_cases = [(_pass_view(c, True), f"({c['rows']}, {C}) p={c['p']}")
               for c in k3]
    n_cases = [(c, f"({c['rows']}, {C})") for c in k4b]
    d_cases = [(c, f"({ROWS}, {c['cols']}) p={c['p']}") for c in drop]
    # headline shapes: f32 at the bench step's shapes
    out += [
        entry("flash_attention_bwd", src + "flash_attention.cu",
              ref + "flash_attention.py:245", launches["K2"], b_cases,
              first(b_cases, lambda c: f32(c) and c["t"] == TRAIN_T
                    and c["lengths"] is None),
              "autograd backward of "
              "torch.nn.functional.scaled_dot_product_attention"),
        entry("layer_norm_bwd", src + "layer_norm.cu",
              ref + "layer_norm.py:122", launches["K4b"], n_cases,
              first(n_cases, f32),
              "autograd backward of torch.nn.functional.layer_norm", "K4b"),
        entry("residual_dropout_ln_fwd", src + "fused_block.cu",
              ref + "fused_block.py:133", launches["K3f"], f_cases,
              first(f_cases, lambda c: f32(c) and c["p"] > 0),
              "composed: F.dropout + add + F.layer_norm (no single call)",
              "K3f"),
        entry("residual_dropout_ln_bwd", src + "fused_block.cu",
              ref + "fused_block.py:169", launches["K3b"], g_cases,
              first(g_cases, lambda c: f32(c) and c["p"] > 0),
              "composed: autograd backward of F.dropout + add + "
              "F.layer_norm (no single call)", "K3b"),
        entry("dropout", src + "dropout.cu", ref + "dropout.py:61",
              launches["K5"], d_cases,
              first(d_cases, lambda c: f32(c) and c["cols"] == FFN),
              "torch.nn.functional.dropout"),
    ]
    if gd is None:
        return {"kernels": out}
    # headline shape: f32 at the BERT-base step's FFN hidden, p = 0.1
    for bwd, name, line in ((False, "gelu_dropout_fwd", 289),
                            (True, "gelu_dropout_bwd", 298)):
        cases = [(_pass_view(c, bwd), f"{c['shape']} p={c['p']}") for c in gd]
        out.append(entry(
            name, src + "gelu_dropout.cu", f"{ref}fused_block.py:{line}",
            launches["K6b" if bwd else "K6f"], cases,
            first(cases, lambda c: f32(c) and c["p"] > 0),
            ("autograd backward of " if bwd else "")
            + "F.dropout(F.gelu(u, approximate='none')) (xla_ms: F.gelu "
            "then the port's dropout kernel, the reference's composed "
            "route)"))
    if fold is not None:
        cases = [(fold, f"{len(fold['sites'])} site keys")]
        out.append(entry(
            "fold_keys", src + "dropout.cu",
            "incubator_mxnet_tpu/parallel/sharded.py:123 (jax.random."
            "fold_in of the step's key; not a Pallas kernel)",
            launches["fold"], cases, _case_row(*cases[0]), None))
    return {"kernels": out}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch  # noqa: F401 — fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    attn, lns = phase_kernels_vs_plain(torch, dev)
    phase_row_fwd_invariance(torch, dev)
    torch.cuda.empty_cache()
    train_cases = phase_train_kernels_vs_plain(torch, dev)
    phase_row_bwd_checks(torch, dev)
    gd_cases = phase_gelu_dropout_vs_plain(torch, dev)
    gd_accuracy = phase_gelu_accuracy(torch, dev)
    phase_small_reference(torch, dev)
    launches, served = phase_serve(torch, dev)
    torch.cuda.empty_cache()
    serve_engine, engine_k4, base = phase_serve_engine(torch, dev)
    launches["K4"] += engine_k4
    torch.cuda.empty_cache()
    serve_spec, spec_k4 = phase_serve_spec(torch, dev, base)
    launches["K4"] += spec_k4
    plane, plane_k4 = {}, 0
    for name, phase in (("gateway_a", phase_gateway_a),
                        ("gateway", phase_gateway), ("disagg", phase_disagg),
                        ("trace", phase_trace), ("fault", phase_fault)):
        plane[name], k4 = phase(torch, dev, base)
        plane_k4 += k4
        torch.cuda.empty_cache()
    launches["K4"] += plane_k4
    del base
    torch.cuda.empty_cache()
    check_result = phase_train_step_check(torch, dev)
    torch.cuda.empty_cache()
    trained, (train_launches, f32_layouts) = phase_train(torch, dev)
    trained["check"] = check_result
    torch.cuda.empty_cache()
    trained_amp, (amp_launches, amp_layouts) = phase_train(torch, dev, "amp")
    torch.cuda.empty_cache()
    trained_tf32, _ = phase_train(torch, dev, "tf32")  # a number, no path
    torch.cuda.empty_cache()
    fold_case = phase_device_keys(torch, dev)
    dp_amp, (dp_amp_launches, dp_amp_layouts) = phase_train_dp(
        torch, dev, trained_amp, "amp")
    torch.cuda.empty_cache()
    dp_f32, (dp_f32_launches, dp_f32_layouts) = phase_train_dp(
        torch, dev, trained, "f32")
    torch.cuda.empty_cache()
    gd_path, gd_launches = phase_gelu_dropout_path(torch, dev)
    torch.cuda.empty_cache()
    for k, n in (list(train_launches.items()) + list(amp_launches.items())
                 + list(dp_amp_launches.items())
                 + list(dp_f32_launches.items())
                 + list(gd_launches.items())):
        launches[k] = launches.get(k, 0) + n
    by_layout = {k: dict(v) for k, v in f32_layouts.items()}
    for layouts in (amp_layouts, dp_amp_layouts, dp_f32_layouts):
        for k, v in layouts.items():
            for name, n in v.items():
                by_layout[k][name] = by_layout[k].get(name, 0) + n
    by_layout["K4"]["f32"] += sum(r["k4_launches"] for r in served) \
        + engine_k4 + spec_k4 + plane_k4
    log(f"[done] launches on the main paths (serving, the serving "
        f"engine's warm-up and traces, the serving plane's gateways, pods "
        f"and traced and faulted engines + {STEPS} timed "
        f"training steps in f32 and {STEPS} under AMP + the DataParallel "
        f"steps, AMP and f32, that launched through the wrappers: the "
        f"eager and the capturing step of each + {GD_STEPS} gelu_dropout "
        f"steps): {launches}; the row kernels' by layout {by_layout}")
    phase_times(torch, attn, lns)
    phase_times_train(torch, *train_cases)
    phase_times_gelu_dropout(torch, gd_cases)
    key_times = phase_times_device_keys(torch, fold_case)
    torch.cuda.empty_cache()
    nd, nd_launches, nd_layouts = phase_nd(torch, dev)
    torch.cuda.empty_cache()
    for k, n in nd_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in nd_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [nd]'s NDArray launches {nd_launches}: {launches}")
    # [elastic] runs after every phase that reads a profile: after it, a
    # profiled DataParallel replay's first kernels went missing from the
    # trace in every full run (PERF.md §7); its model is the [serve
    # engine]'s (gpt2_small, seed 0) built again
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small

    plane["elastic"], elastic_k4 = phase_elastic(
        torch, dev, {"model": gpt2_small(device=dev, seed=0).eval()})
    launches["K4"] += elastic_k4
    by_layout["K4"]["f32"] += elastic_k4
    log(f"[done] with [elastic]'s {elastic_k4} K4 launches: K4 "
        f"{launches['K4']}, by layout {by_layout['K4']}")
    log(f"[done] phases took {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(json.dumps({"train": trained}))
    log(json.dumps({"train_amp": trained_amp}))
    log(json.dumps({"train_tf32": trained_tf32}))
    dp_amp["device_key_vs_by_value_ms"] = key_times
    log(json.dumps({"train_dp_amp": dp_amp}))
    log(json.dumps({"train_dp": dp_f32}))
    log(json.dumps({"serve": served}))
    log(json.dumps({"serve_engine": serve_engine}))
    log(json.dumps({"serve_spec": serve_spec}))
    for name, numbers in plane.items():
        log(json.dumps({name: numbers}))
    gd_path["max_abs_err_vs_float64"] = {
        name: {"k6": k6, "erff": erff}
        for name, (k6, erff) in gd_accuracy.items()}
    log(json.dumps({"gelu_dropout": gd_path}))
    log(json.dumps({"nd": nd}))
    log(json.dumps(kernels_line(attn, lns, launches, train_cases,
                                gd_cases, by_layout, fold_case)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
