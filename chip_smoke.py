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
   float32, bfloat16 and float16: the forward kernels at the shapes of
   the serving path (flash attention also at the training step's call),
   the training
   kernels (flash-attention backward, fused residual +
   dropout + LayerNorm forward and backward, LayerNorm backward, dropout)
   at the shapes of the BERT-base training step, dropout masks bit for
   bit; the row backward (K4b, K3 backward) also at 65536 rows, at one
   row and at each vector count a lane can take, two calls bitwise
   equal; the row kernels also in AMP's layouts (bf16 or f16), K3 with
   f32 x, a 2-byte h and f32 gamma/beta (8192 and 1000 rows: equal to the
   f32 kernels on h widened to f32 bit for bit, its mask the dropout
   kernel's), K4 and K4b with a 2-byte x and f32 gamma/beta (8192 and 8
   rows), dgamma/dbeta in
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
   busy time of one step from the package's kernel census (every
   profiled window of the script goes through ``profiler.start()``,
   ``stop()`` and ``telemetry.kernels.census``); then the same workload
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
   device time split by kernel (the kernel census).

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

9. ``[amp16]`` (after ``[gluon]``): BERT-base 64 x 128 under
   ``amp.init("float16")``: one step through the kernels against the
   plain versions at p = 0 (loss, unscaled gradients, one Adam step); 20
   steps at p = 0.1 in MXNet's loop (``scale_loss``, ``backward``,
   ``has_overflow``, skip and ``update_scale`` on an overflow, else
   ``trainer.step``), launches a step by layout (K3 in f32 x, f16 h; the
   MLM LayerNorm f16 x), every flash kernel float16 (a profiled step);
   the same model through ``DataParallel`` (one capture, replays bit for
   bit the eager step function); ``net.cast("float16")`` through
   ``Trainer("adam", {"multi_precision": True})``, 10 steps, each float16
   weight its f32 master's cast after every step, the row kernels
   all-f16.
10. ``[dense]``: BERT-base ``use_flash=False`` (``batch_dot``,
   ``masked_softmax`` over the dense (N*H, T, T) mask, dropout on the
   probabilities through K5) at 64 x 128 with ragged lengths against the
   flash model on the same weights (f32 and bf16 AMP), both paths' step
   times; ``BERTClassifier`` over it, 10 steps; ``gpt2_small(
   tie_weights=False)`` with its head a copy of the embedding through
   ``GPTModel.generate`` (8 x 100 -> 64) and a ``ServeEngine`` over trace
   A's first 8 requests: the tied model's tokens, one decode capture, and
   a recapture after a new tensor is bound to ``lm_head.weight``.
11. ``[vision]`` (after ``[dense]``): ``bench.py:310``'s ResNet-50-v1
   training as written (batch 128 x 3 x 224^2, SGD with momentum 0.9,
   softmax CE, ``DataParallel``: one CUDA graph) in f32 and under
   ``amp.init("bfloat16")``: images/s, the median step, the idle share
   from CUDA events, one capture, the model FLOPs share from the net's
   own conv and dense shapes, a profiled replay's device time by kernel
   class; one batch-4 step on the card against the CPU's f32 run (loss,
   running statistics) and f64 run (every gradient); one
   running-statistics update a step through the eager, capturing and
   replayed steps; the gluon loop eager and hybridized against
   ``DataParallel``; ``alexnet()`` at batch 128 with its two dropouts
   through K5 inside the replayed step (launches counted, new masks a
   replay, K5 against its plain version); the packaged
   ``mobilenet0.25_digits`` weights and every zoo family on the card
   against the CPU.
12. ``[np4]`` (after ``[vision]``): a reference-style user script that
   begins with ``npx.set_np()`` on ``cuda:0``: two self-attention layers
   of npx ops (``interleaved_matmul_selfatt_qk``/``_valatt``,
   ``masked_softmax``, ``sequence_mask``, ``layer_norm`` on K4/K4b,
   ``dropout`` on K5) at 8 x 64 x 768, 12 heads, ``one_hot``/``pick``
   losses, a ``topk`` metric, ``clip_global_norm`` and three SGD steps
   under ``autograd.record()``, against the same script on the CPU at
   p = 0 and at p = 0.1 (the same dropout keys), its K4, K4b and K5
   launches exact; the dropout contract; every ``np.linalg`` name on the
   card against the CPU and ``solve``/``svd`` through the funnel against
   ``torch.linalg``; 10^6 draws of each of the 20 distributions against
   their moments; a legacy ``.params`` round trip through
   ``load_parameters``; the funnel's host time of ``topk``, ``pick``,
   ``one_hot`` and ``reshape`` with codes.
13. ``[observe]`` (after ``[np4]``): the profiler and its consumers,
   through the package's own API: ``bench.py:400``'s cross-check on the
   port (``profiler.start()``, three ``DataParallel`` steps of BERT-base
   at 64 x 128 under bf16 AMP, ``profiler.stop()``,
   ``telemetry.kernels.census`` and ``program_mfu``), each port kernel's
   census count equal to the captured graph's launch log, its bytes and
   FLOPs its wrapper's ``cost()`` times its count, byte coverage 1 over
   them, the trace MFU at least 0.95 of the wall MFU, the roofline
   phases summing to the census's device time; trace A through
   ``ServeEngine`` on ``gpt2_small`` with one profiled decode replay (25
   K4 launches, its device slices inside the step's host span in
   ``tracing.chrome_trace(include_device=True)``); ``[np4]``'s funnel
   timings with the stage probes; the NaN hook raising at the CPU's op
   on an eager step and guarding a ``hybridize`` capture without a host
   sync; the auditor naming ``LossScaler.has_overflow``'s host sync in an
   eager float16 step and none in the hybridized BERT block; a measured
   copy rate and bf16 product rate beside the data sheet's. After
   ``[elastic]``, a profiled decode replay with no warm-up cycle, and one
   after a replay inside a pause, reports whether records are lost.

14. ``[fit]`` (after ``[observe]``): BERT-base at full width in
   ``BERTClassifier(num_classes=2, dropout=0.1)``, seeded, hybridized,
   under bf16 AMP, fine-tuned through ``gluon.contrib.estimator.
   Estimator.fit(batches=64)`` with ``Trainer("adam")``, fed by a
   ``gluon.data.DataLoader`` with two worker processes (2048 seeded rows
   of 128 tokens, batch 32, shuffled, ``pin_memory``), with the logging,
   validation (every 32 batches), checkpoint and telemetry handlers and a
   ``ResilienceHandler`` over a ``TrainingCheckpointer`` (every 16
   steps): each kernel's launches over the fit (the launch log) and in a
   profiled step (the census) against the model's count a step, one
   training and one predict-mode capture, the first 4 losses against
   the same fit on the plain versions, the first epoch's batches against
   the loader without workers on the CPU, a preemption at batch 40
   resumed bit for bit by a fresh net and Trainer, a crash injected at
   batch 50 (``inject_at("estimator_step")``) resumed from the last
   checkpoint; the median step's wall and CUDA-event time, the busy time
   of a step, examples/s, the goodput ledger's seconds.
15. ``[pipeline]``: ``bench.py:239``'s input pipeline on the port: 512
   seeded 256^2 images packed with ``recordio.pack_img`` into an indexed
   record file, ``io.ImageRecordIter`` (crop, mirror, 8 threads,
   prefetch 4): the best images/s over 2 epochs after a warm one, the
   codec that ran, the native reader (``librtio``, built with g++) used,
   the host's cores; one batch on the card equal to the CPU iterator's.
16. ``[dist]`` (after ``[pipeline]``, before ``[elastic]``): distributed
   training. An NCCL world of one: ``bench.py:337``'s BERT-base step
   (64 x 128, dropout 0.1, Adam, MLM CE, bf16 AMP) through
   ``DataParallel`` on a (dp 1, tp 1) mesh with ``tp_param_shardings``
   and ``seq_shard_axis="tp"``, bit for bit the no-mesh step (losses and
   parameters after 3 steps), one capture each, launches exact, a
   replay's wall and idle share. Then 4 processes on ``cuda:0`` (this
   script with ``--dist-worker``): NCCL's refusal of several ranks on one
   card logged, then a gloo world whose CUDA tensors go through host
   memory: BERT-base 16 x 128 f32 over dp 2 x tp 2 with its compute split
   over tp and Megatron SP, each rank storing only its blocks of the cut
   parameters, held to the no-mesh step (losses 1e-4 relative, the
   parameters after 3 steps at the train phases' tolerance, with the
   tests' bound where a gradient is near zero, and one SGD step's update
   at lr 1, the reduced gradient, at the same tolerance), a dp replica's
   blocks its twin's bits, each rank's stored bytes (parameters,
   gradients, Adam) against the whole model's and a whole-tensor
   layout's (parameters and gradients whole, Adam on the blocks) and its
   allocator peak, the step's wall, idle share and exchanges by axis and
   op (buffer and wire MiB) against TP alone, a bf16 p = 0.1 step and the
   dropout keys' contract on K5; ring attention over sp = 4 at T = 32768
   (causal and not) against one K1/K2 call over the whole sequence, one
   hop's K1 and K2 (a full block and a causal one, K2 given the whole
   sequence's O and lse) against their plain versions, K1/K2 launches a
   hop, its time against K1's; ``[dist 4]``: the BERT-base run loses one
   dp replica through the ``topology_change`` seam (`fault.elastic`: a
   vote, the shardcheck pre-flight, a drain checkpoint, the rendezvous,
   the trainer rebuilt on dp 1 x tp 2), the survivors' parameters and
   Adam state bit for bit the pre-transition ones, their next steps'
   losses falling, the pre-flight's abort on a layout that would
   replicate the cut parameters, the 4-rank checkpoint resumed on 2 ranks
   bit for bit; ``[dist 5]``: GPipe over pp = 4 and top-2 MoE over ep = 4
   against one rank, 3 falling training steps each. ``--only dist`` runs
   the build and ``[dist]`` alone (no result line).
17. ``[int8]`` (after ``[fleet]``, before ``[elastic]``): ``bench.py:1754``'s
   int8 ResNet-50 pair on the port: ``resnet50_v1`` at batch 64 x 3 x
   224^2, an f32 net and its copy through ``contrib.quantization.
   quantize_net`` (naive calibration on x[:8]), both hybridized. The
   rewrite's census against the reference's counts; the int8 net on x[:8]
   through the Q1/Q2 kernels against the same net on their plain versions,
   bit for bit, and Q1's int32 sums at the stem, a 3x3 and the Dense; the
   card against the CPU; 54 Q1 (16 of them with the residual add in the
   epilogue) and 1 Q2 launches an eager forward, no layout conversion;
   Q1 at the stem, a stage-1 3x3, stage 4's and stage 1's last 1x1 with
   their residuals and the Dense and Q2 at the stem's pool, each at the
   forward's own channels-last tensors, timed beside their bounds, plain
   versions and cuDNN's f32 and bf16 convolutions (``torch._int_mm`` for
   the Dense and the stage-4 1x1's product); the interleaved timed pair
   (best images/s, the median ratio), device ms a forward (a replay
   profiled through ``mx.profiler``, each of its 55 port kernels joined to
   its launch-log entry), one replay by kernel (Q1 by layer class, Q2,
   the rest), top-1 agreement and logit
   error against f32. ``[rnn]``: the store's
   ``lstm_charlm_tiny`` on the card against the CPU; a 2-layer
   bidirectional LSTM, a GRU and an rnn_tanh RNN forward and backward
   against the CPU; the dropout between layers through K5 in training;
   three ``Trainer`` steps of the char LM, eager and hybridized.
   ``--only int8`` runs the build, ``[int8]`` and ``[rnn]`` alone (no
   result line).

Everything it has to say comes on earlier lines: the card's name and
power limit (``nvidia-smi``), ``{"train": ...}``, ``{"train_amp": ...}``,
``{"train_tf32": ...}``, ``{"train_dp_amp": ...}``, ``{"train_dp": ...}``,
``{"serve": ...}``, ``{"serve_engine": ...}``, ``{"serve_spec": ...}``,
the serving plane's (``{"gateway_a": ...}`` ... ``{"elastic": ...}``) and
``{"gelu_dropout": ...}``, ``{"nd": ...}``, ``{"gluon": ...}``,
``{"amp16": ...}``, ``{"dense": ...}``, ``{"vision": ...}``,
``{"np4": ...}``, ``{"observe": ...}``, ``{"fit": ...}``,
``{"pipeline": ...}``, ``{"dist": ...}``, ``{"shard": ...}``,
``{"fleet": ...}``, ``{"int8": ...}``, ``{"rnn": ...}`` lines, one
``{"kernels": [...]}`` line (the fold kernel of the device keys, then Q1
and Q2, last), and
last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
and prints no result; so does a run without a CUDA device, or one
outside a checkout of the repository. TF32 is off for matmuls and cuDNN
except in the TF32 training run, which restores it.
"""
from __future__ import annotations

import importlib
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "tf32": 495e12}
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
# float16: the same rule at its own precision (10 stored mantissa bits)
F16_RTOL, F16_ATOL = 2.0 ** -10, 1e-5
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
# float16: the same at its own precision, plus the elementwise rule's
# absolute term (F16_ATOL) an element: a float16 gradient near zero is the
# f32 noise of sums in another order (its f16 x f16 products are exact,
# their sums are not), or lies in its subnormals (spacing 2^-24)
ATTN_F16_NORM_TOL, ATTN_F16_MAX_TOL = 2.0 ** -10, 2.0 ** -9
F16_SUBNORMAL = 2.0 ** -24
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
# the path under amp.init("float16"), kernels against plain versions (the
# same f16 products around K6): K6's output within one f16 spacing of the
# plain version's, carried through one f16 product 3072 deep; the output
# and every gradient within 2^-7 of their largest magnitude
GD_PATH_F16_TOL = 2.0 ** -7
GD_WARMUP, GD_STEPS = 1, 5
# K6's gelu and gelu' against float64 at this many points of [-10, 10]
GD_SWEEP = 2 ** 22 + 1
GD_RAGGED = (1000, 771)          # numel not a multiple of the vector width
GD_LARGE = (65536, FFN)          # BERT-base at sequence 512, bf16

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
    bfloat16 within BF16_RTOL * |plain| + BF16_ATOL elementwise, float16
    within F16_RTOL * |plain| + F16_ATOL."""
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((d <= BF16_RTOL * r.abs() + BF16_ATOL).all())
    elif got.dtype == torch.float16:
        ok = bool((d <= F16_RTOL * r.abs() + F16_ATOL).all())
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
    elif got.dtype == torch.float16:
        ok = (d.norm().item() <= ATTN_F16_NORM_TOL * r.norm().item()
              + F16_ATOL * r.numel() ** 0.5
              and err <= ATTN_F16_MAX_TOL * r.abs().max().item() + F16_ATOL)
    else:
        ok = err <= f32_tol
    return ok, err, rel, top


def tol_text(dtype, f32_tol, attn=False):
    if dtype == "float32":
        return f"tol {f32_tol:g}"
    if dtype == "float16":
        if attn:
            return (f"tol normwise 2^-10, max 2^-9*max|plain| (+ "
                    f"{F16_ATOL:g} an element)")
        return f"tol 2^-10*|plain| + {F16_ATOL:g} elementwise"
    if attn:
        return "tol normwise 2^-7, max 2^-6*max|plain|"
    return f"tol 2^-7*|plain| + {BF16_ATOL:g} elementwise"


def on_host(lengths):
    """``lengths`` on the host (or None): a cost reckons lengths it can
    read without waiting for the card."""
    return None if lengths is None else lengths.cpu()


def bound(bytes_moved, flops, dtype, tensor_cores=False):
    """(least ms, "bytes" or "operations"); ``tensor_cores``: f32
    operations at the 3xTF32 rate (K1, K2)."""
    rate = (PEAK_3XTF32 if tensor_cores and dtype == "float32"
            else PEAK_FLOPS[dtype])
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


# element types as they appear in the kernels' mangled names
_MANGLED_DTYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def _flash_label(mangled):
    """'fwd f32 d<=64' for a flash kernel's mangled name, else None."""
    import re

    m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv|bwd_delta)_kernelI"
                  r"(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?", mangled)
    if m is None:
        return None
    kind = m.group(1).replace("bwd_", "")
    dt = _MANGLED_DTYPES[m.group(2)]
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
    take three element types (x, h, gamma); a repeated bf16 or f16 is a
    substitution (``S1_``) of the one 2-byte type a kernel takes, float
    is always ``f``."""
    import re

    m = re.search(r"(gelu_dropout_kernel|ln_fwd_kernel|ln_bwd_kernel|"
                  r"ln_partials_reduce_kernel)I((?:f|13__nv_bfloat16|6__half|"
                  r"S\d*_)+)((?:L[bi]\d+E)*)", mangled)
    if m is None:
        return None
    kind = m.group(1)
    types = []
    for t in re.findall(r"f|13__nv_bfloat16|6__half|S\d*_", m.group(2)):
        if t.startswith("S"):
            t = next(x for x in types if x != "f32")
            types.append(t)
        else:
            types.append(_MANGLED_DTYPES[t])
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
        for dt, dcode in (("f32", 0), ("bf16", 1), ("f16", 2)):
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
        # forward, dq and dk/dv at d <= 64 and 128, and the delta pre-pass,
        # in f32, bf16 and f16
        check(len(sass) == 21, f"expected 21 flash kernels in the SASS, "
              f"found {sorted(sass)}")

    if tool is not None:
        igmma = sum(1 for line in sass_of("int8_conv").splitlines()
                    if " IGMMA." in line or " IGMMA " in line)
        log(f"[build] int8_conv: {igmma} IGMMA (int8 wgmma) instructions "
            f"in the SASS")
        check(igmma > 0, "int8_conv has no int8 wgmma instruction")
    for stem in ("int8_conv", "int8_pool"):
        check(all(s == 0 for _, s in _ptxas_report(logs[stem]).values()),
              f"{stem} spills registers")

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
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    rows_f32 = sorted(set(SERVE_LN_ROWS) | {N * t for t in ATTN_T})
    specs = [(f32, f32, rows) for rows in rows_f32]
    for low in (bf16, f16):
        specs += [(low, low, rows) for rows in [N * t for t in ATTN_T] + [N]]
        specs += [(low, f32, ROWS), (low, f32, N)]
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
    bits whatever the call's row count and grid: K4 (f32, AMP's bf16 or
    f16 x with f32 gamma, all-f16) and K3 at p = 0.1 on a device key
    (f32, AMP's f32 x with bf16 or f16 h, all-f16) on the first n rows of
    a 65536-row input,
    against the same rows of the whole call, at each of
    `fwd_invariance_rows`; K3's mask the dropout kernel's."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    sms = ln.sm_count(dev)
    rows_list = fwd_invariance_rows(sms)
    big = INVARIANCE_ROWS
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    key = ph.DeviceKey(torch.tensor([1414213562, 1732050807], device=dev),
                       torch.tensor(3, device=dev), 5, {})
    words = tuple(int(w) for w in ph.key_words(key))
    g = torch.Generator(device=dev).manual_seed(29)
    for name, xdt, hdt, pdt in (("K4", f32, None, f32),
                                ("K4", bf16, None, f32),
                                ("K4", f16, None, f32),
                                ("K4", f16, None, f16),
                                ("K3", f32, f32, f32),
                                ("K3", f32, bf16, f32),
                                ("K3", f32, f16, f32),
                                ("K3", f16, f16, f16)):
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
        if h is not None and xdt == f32:  # the dropout kernel's mask
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
               "bit" if h is not None and xdt == f32 else ""))
    return rows_list


def _dt(dtype):
    return str(dtype).replace("torch.", "")


def phase_kernels_vs_plain(torch, dev):
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
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
    gpu = gpt_tiny(vocab_size=97, max_length=64, dropout=0.0, device=dev,
                   seed=3)
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
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
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


def profiled(torch, fn, held=True):
    """The kernel census of one ``fn()`` through the package's own
    profiler (``profiler.start()``, ``fn()``, ``profiler.stop()``,
    ``kernels.census()``): every profiled window of this script goes
    through it. ``held`` (the default): ``fn()`` runs once inside
    ``profiler.pause()`` first, its records dropped, as the first
    kernels of a profiling session after the process's first lose their
    records, a graph's replay's and eager launches' alike (PERF.md §7);
    the census's ``meta["lost_launches"]`` says whether the window lost
    any."""
    from incubator_mxnet_tpu_torch import profiler
    from incubator_mxnet_tpu_torch.telemetry import kernels

    torch.cuda.synchronize()
    profiler.start()
    try:
        if held:
            profiler.pause()
            fn()
            torch.cuda.synchronize()
            profiler.resume()
        fn()
        torch.cuda.synchronize()
    finally:
        profiler.stop()
    return kernels.census()


def census_ms(cen):
    """A census's device busy ms (one stream: the sum of its kernels',
    copies' and sets' times)."""
    return cen["meta"]["total_device_us"] / 1e3


def census_launches(cen):
    """(launches of the port's kernels in a census, in the counters'
    units; the row backward's reduction kernels seen). A K3b or K4b call
    counts its row kernel and its reduction, as the counters do."""
    out = {k: 0 for k in DP_STEP_LAUNCHES}
    reduce = 0
    for r in cen["rows"]:
        got = _obs_class(r["name"])
        if got is None:
            continue
        cls = got[0]
        if cls == "reduce":
            reduce += r["count"]
        else:
            out[cls] += r["count"] * (2 if cls in ("K4b", "K3b") else 1)
    return out, reduce


def census_top(cen, n=40):
    """The census's ``n`` longest kernels: [{ms, calls, name}]."""
    return [dict(ms=r["time_us"] / 1e3, calls=r["count"],
                 name=r["name"][:160]) for r in cen["rows"][:n]]


def profiled_replay(torch, slots, name="decode"):
    """(launches of the port's kernels, device ms, {kernel: device us}) of
    one profiled replay of the engine's ``name`` graph (`profiled`, held:
    a replay inside a pause first); the LayerNorm forward row kernels
    named "K4 ..." (mode 0) or "K3 ...". A K3b or K4b launch counts its
    row kernel and its reduction, as the counters do."""
    graph = slots._graphs[name][0]
    cen = profiled(torch, graph.replay)
    by_kernel = {}
    for r in cen["rows"]:
        key = r["name"].split("(")[0].replace("void ", "")
        got = _obs_class(r["name"])
        if got is not None and got[0] in ("K4", "K3f"):
            key = ("K4 " if got[0] == "K4" else "K3 ") + key
        by_kernel[key] = by_kernel.get(key, 0.0) + r["time_us"]
    return census_launches(cen)[0], census_ms(cen), by_kernel


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

    fa = importlib.import_module(

        "incubator_mxnet_tpu_torch.ops.flash_attention")
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
        # the wrapper's reckoning: q, k, v read where live, o and lse
        # written in full; rows and keys past each length are not needed
        c["bound_ms"], c["bound_by"] = bound(
            *fa.cost(n, H, t, t, D, c["base"].dtype, on_host(c["lengths"]),
                     c["causal"]), dt, tensor_cores=True)
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
        rows = c["rows"]
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
            *ln.cost(rows, C, x.dtype, gm.dtype), _ops_dtype(c))
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
    return _dt(c["dtype"]) if c["layout"] in ("f32", "bf16", "f16") \
        else "float32"


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
    """{kernel name: device ms of one call of ``fn``} from the kernel
    census (`profiled`) of ``reps`` calls cycling through the argument
    ``sets`` (after a warm-up call)."""
    def calls():
        for i in range(reps):
            fn(*sets[i % len(sets)])

    fn(*sets[0])
    out = {}
    for r in profiled(torch, calls)["rows"]:
        name = r["name"].split("(")[0].replace("void ", "")
        out[name] = out.get(name, 0.0) + r["time_us"] / 1e3 / reps
    return out


def _split_text(split):
    return ", ".join(f"{k} {v:.4f} ms" for k, v in
                     sorted(split.items(), key=lambda kv: -kv[1]))


def _counters():
    """The port's launch counters: name -> (module, attribute)."""
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
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


def grads_to_none(model):
    """Every parameter's gradient None (torch's ``zero_grad(set_to_none=
    True)``): a step then takes the gradients backward writes, with no
    zeroing pass (gluon's ``zero_grad()`` zeroes them in place)."""
    for prm in model.parameters():
        prm.grad = None


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
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
    sites give them: f32, bf16, f16, and AMP's layouts in either 2-byte
    dtype, f32 x with a bf16 or f16 h and f32 gamma/beta (K3, also at
    1000 rows) and a bf16 or f16 x with f32 gamma/beta (K4b, also at N
    rows); K3 at p = 0.1 and p = 0."""
    from incubator_mxnet_tpu_torch.ops.layer_norm import layout_name

    f32 = torch.float32
    k3, k4b = [], []
    specs = [(f32, f32, f32, ROWS, True)]
    for low in (torch.bfloat16, torch.float16):
        specs += [(low, low, low, ROWS, True), (f32, low, f32, ROWS, False),
                  (f32, low, f32, 1000, False), (low, low, f32, ROWS, True),
                  (low, low, f32, N, True)]
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
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
    low = got.dtype in (torch.bfloat16, torch.float16)
    if low and not bf16_sums:
        ok, err, rel = agree(got, ref, 0.0)
        _log_check(tag, what, got.dtype, ok, err, rel, 0.0)
        return err
    tol = ln.column_sum_tol(terms, rows,
                            ln.row_blocks(rows, ln.sm_count(got.device)))
    if low:
        rtol = BF16_RTOL if got.dtype == torch.bfloat16 else F16_RTOL
        tol = rtol * ref.float().abs() + 2 * tol
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
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
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
            same = dh_zeros_are_the_mask(torch, got[1], ref[1], keep)
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
    """AMP's K3 layout (f32 x, bf16 or f16 h): the forward and backward
    equal the f32 kernels on h widened to f32, bit for bit (dh rounded to
    h's dtype once), two backward calls are bitwise equal, and at p > 0
    the zeros of dh are the dropout kernel's (K5) mask for the same key."""
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
            and torch.equal(got[1], g32[1].to(c["h"].dtype))
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
        same = dh_zeros_are_the_mask(torch, got[1], got[0], k5)
        log(f"[K3 mixed] {what}: dh's zeros are the dropout kernel's mask "
            f"bit for bit: {same}")
        check(same, f"K3 {what}: mask differs from K5's")


def dh_zeros_are_the_mask(torch, dh, dx, keep):
    """Whether dh (= ds * scale where kept, else 0) is nonzero exactly
    where ``keep`` holds and dx (ds, or the plain dh) is nonzero. In
    float16 a ds within two subnormal spacings (2^-24) of zero can round
    to 0 on one side and to the smallest subnormal on the other: such
    elements are exempt, but a dropped element is never nonzero."""
    nz, want = dh != 0, keep & (dx != 0)
    if dh.dtype != torch.float16:
        return torch.equal(nz, want)
    tiny = ((dh.float().abs() <= 2 * F16_SUBNORMAL)
            & (dx.float().abs() <= 2 * F16_SUBNORMAL))
    return (not bool((nz & ~keep).any())
            and bool(((nz == want) | tiny).all()))


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
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
                same = dh_zeros_are_the_mask(torch, got[1], got[0], keep)
                log(f"[row bwd] {kind} {what}: dh's zeros are the plain "
                    f"Philox mask's: {same}")
                check(same, f"row bwd {kind} {what}: mask differs from K5's")


def phase_train_step_check(torch, dev):
    """One BERT-base step at full width on the kernels against the same
    step on the plain versions: same weights, same dropout keys."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base

    models = {impl: bert_base(dropout=TRAIN_P, device=dev, seed=21,
                              impl=impl)
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
        with autograd.train_mode():
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
TRAIN_MODES = {"f32": "float32", "amp": "bfloat16", "tf32": "tf32",
               "amp16": "float16"}
F32_LAYOUT_LAUNCHES = {k: {"f32": sum(v.values())}
                       for k, v in AMP_LAYOUT_LAUNCHES.items()}


def phase_train(torch, dev, mode="f32"):
    """The bench.py BERT-base training workload, 2 warm-up + 10 timed
    steps, launch counts per step (by layout under AMP), and one profiled
    step. ``mode``: "f32" (TF32 off), "amp" (under amp.init("bfloat16"),
    deinit in a finally), or "tf32" (f32 with TF32 products, restored
    after)."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam

    tag = {"f32": "train", "amp": "train amp", "tf32": "train tf32"}[mode]
    model = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                      seed=0)
    trainer = Trainer(model.collect_params(), Adam(learning_rate=TRAIN_LR))
    ce = SoftmaxCrossEntropyLoss()
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    n_params = sum(p.numel() for p in model.parameters())

    def step(fwd_counts=None):
        grads_to_none(model)
        with autograd.train_mode():
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

        cen = profiled(torch, step)
    finally:
        amp.deinit()
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    dev_ms = census_ms(cen)
    tokens_s = TRAIN_B * TRAIN_T / (med / 1e3)
    flops_token = 6.0 * n_params + 12.0 * 12 * TRAIN_T * C
    peak = TRAIN_MODES[mode]
    share = flops_token * tokens_s / PEAK_FLOPS[peak]
    idle = 1 - dev_ms / med if dev_ms > 0 else None
    log(f"[{tag}] median step {med:.2f} ms, {tokens_s:.1f} tokens/s, "
        f"model FLOPs {flops_token:.4g}/token -> share of the {peak} peak "
        f"({PEAK_FLOPS[peak] / 1e12:g} TFLOP/s) {share:.4f}; device busy "
        f"{dev_ms:.2f} ms of a step (the kernel census) -> idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured"))
    by_kernel = census_top(cen, len(cen["rows"]))
    for e in by_kernel[:24 if mode == "amp" else 14]:
        log(f"[{tag}]   {e['ms']:8.3f} ms x{e['calls']:4d}  {e['name'][:90]}")
    row_bwd = {k: sum(r["time_us"] / 1e3 for r in cen["rows"]
                      if k in r["name"])
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
    c["bound_ms"], c["bound_by"] = bound(*dp.fold_cost(n), "float32")
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
    ``mode``: "amp" (bf16), "amp16" (float16, without loss scaling, as
    the reference's DataParallel steps) or "f32"."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    tag = {"f32": "train dp", "amp": "train dp amp",
           "amp16": "amp16 dp"}[mode]
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
    want_layout = {"amp": AMP_LAYOUT_LAUNCHES,
                   "amp16": AMP16_LAYOUT_LAUNCHES}.get(mode,
                                                       F32_LAYOUT_LAUNCHES)
    none = {k: 0 for k in DP_STEP_LAUNCHES}
    if mode in ("amp", "amp16"):
        amp.init("bfloat16" if mode == "amp" else "float16")
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

        # one profiled replay, held (`profiled`: a replay inside a pause
        # first, as a replay profiled as tracing starts can lose its first
        # kernels' records, PERF.md §7); a census that lost launches is
        # profiled again, at most three times, and the tries are reported
        for tries in range(1, 4):
            cen = profiled(torch, lambda: dps[0].step(tokens, labels))
            seen, reduce = census_launches(cen)
            if seen == DP_STEP_LAUNCHES \
                    and cen["meta"].get("lost_launches") == 0:
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
    dev_ms = census_ms(cen)
    tokens_s = TRAIN_B * TRAIN_T / (med / 1e3)
    flops_token = 6.0 * n_params + 12.0 * 12 * TRAIN_T * C
    peak = TRAIN_MODES[mode]
    share = flops_token * tokens_s / PEAK_FLOPS[peak]
    idle = 1 - dev_ms / med if dev_ms > 0 else None
    by_kernel = census_top(cen, len(cen["rows"]))
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
        f"replay (the kernel census, {sum(e['calls'] for e in by_kernel)} "
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
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
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
        t, b = c["t"], c["b"]
        # the wrapper's reckoning: q, k, v, o, dO read where live; dq, dk,
        # dv, lse and delta in full
        c["bound_ms"], c["bound_by"] = bound(
            *fa.bwd_cost(b, H, t, t, D, c["base"].dtype, on_host(c["lengths"]),
                         c["causal"]), _dt(c["dtype"]), tensor_cores=True)
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
        sets = input_sets([c["x"], c["h"]], 20)  # outputs kept: y cycles
        c["ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="kernel"), sets, 20, keep=True)
        c["plain_ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="plain"), sets, 5, keep=True)
        c["library_ms"] = time_ms(lambda x, h: F.layer_norm(
            x + F.dropout(h, p, training=True), (C,), gm, bt, 1e-5), sets,
            20, keep=True)
        c["bound_ms"], c["bound_by"] = bound(
            *fb.cost(rows, C, c["x"].dtype, c["h"].dtype, gm.dtype), dt)
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
            *fb.bwd_cost(rows, C, c["x"].dtype, c["h"].dtype, gm.dtype), dt)
        c["bwd_split"] = kernel_split_ms(
            torch, lambda x, h, dy: fb.residual_dropout_ln_bwd(
                x, h, dy, m, r, gm, key, p, impl="kernel"), bsets, 20)
        what = f"({rows}, {C}) {c['layout']} p={p}"
        log(f"[time] K3 {what} backward by kernel "
            f"(the kernel census, a call): {_split_text(c['bwd_split'])}")
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
            *ln.bwd_cost(rows, C, c["x"].dtype, gm.dtype), dt)
        c["split"] = kernel_split_ms(torch, lambda x, dy: ln.layer_norm_bwd(
            x, dy, m, r, gm, impl="kernel"), sets, 20)
        what = f"({rows}, {C}) {c['layout']}"
        log(f"[time] K4b {what} by kernel (the kernel census, a "
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
        c["bound_ms"], c["bound_by"] = bound(
            *dp.cost(c["x"].numel(), c["x"].dtype), _dt(c["dtype"]))
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
    specs = [((ROWS, FFN), dt, p)
             for dt in (torch.float32, torch.bfloat16, torch.float16)
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
    from incubator_mxnet_tpu_torch.initializer import generator_scope

    g = torch.Generator(device=dev).manual_seed(31)
    d1 = nn.Dense(FFN, in_units=C, flatten=False, device=dev)
    d2 = nn.Dense(C, in_units=FFN, flatten=False, device=dev)
    for layer in (d1, d2):
        with generator_scope(g):
            layer.initialize()
        with torch.no_grad():
            layer.bias.data()._data.normal_(0, 0.1, generator=g)
    params = [p.data()._data for p in (d1.weight, d1.bias, d2.weight,
                                       d2.bias)]
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
    # the same path under float16 AMP: the Dense products in f16, K6 in f16
    from incubator_mxnet_tpu_torch import amp

    f16 = {}
    amp.init("float16")
    try:
        for impl in ("auto", "plain"):
            step(impl)
            torch.cuda.synchronize()
            reset_counts()
            f16[impl] = (step(impl), read_counts())
            torch.cuda.synchronize()
    finally:
        amp.deinit()
    w16 = 0.0
    for name, got, ref in zip(["y"] + names, f16["auto"][0], f16["plain"][0]):
        check(got.shape == ref.shape
              and bool(torch.isfinite(got.float()).all()),
              f"gelu_dropout path under float16 AMP: {name} malformed")
        scale = ref.float().abs().max().item()
        w16 = max(w16, (got.float() - ref.float()).abs().max().item()
                  / max(scale, 1e-30))
    ok16 = (f16["auto"][1] == expect["auto"] and f16["plain"][1] == zero
            and w16 <= GD_PATH_F16_TOL)
    log(f"[gelu_dropout] under amp.init('float16'): y "
        f"{_dt(f16['auto'][0][0].dtype)}, launches {f16['auto'][1]}; auto "
        f"vs plain worst max|d| / "
        f"max|plain| {w16:.2e} (tol 2^-7): {'ok' if ok16 else 'EXCEEDED'}")
    check(ok16, "gelu_dropout path under float16 AMP disagrees with plain")
    reset_counts()
    cen = profiled(torch, lambda: step("auto"))
    held = read_counts()        # the profiled step and the one held
    launches["K6f"] += held["K6f"]
    launches["K6b"] += held["K6b"]
    dev_ms = census_ms(cen)
    k6_ms = sum(r["time_us"] for r in cen["rows"]
                if "gelu_dropout" in r["name"]) / 1e3
    result = dict(batch=TRAIN_B, seq=TRAIN_T, units=C, hidden=FFN, p=TRAIN_P,
                  steps=GD_STEPS,
                  **{f"{k}_step_ms": r["walls"] for k, r in runs.items()},
                  **{f"{k}_median_step_ms": med(r["walls"])
                     for k, r in runs.items()},
                  launches_per_step={k: r["counts"][0]
                                     for k, r in runs.items()},
                  worst_rel_err_vs_plain=worst["plain"],
                  f16_amp_worst_rel_err_vs_plain=w16,
                  worst_rel_err_vs_xla=worst["xla"],
                  device_ms_per_step=dev_ms, k6_device_ms_per_step=k6_ms)
    auto_ms = result["auto_median_step_ms"]
    result["idle_share"] = 1 - dev_ms / auto_ms if dev_ms > 0 else None
    log(f"[gelu_dropout] median step ms: auto (K6) {auto_ms:.3f}, xla "
        f"(F.gelu + K5) {result['xla_median_step_ms']:.3f}, plain "
        f"{result['plain_median_step_ms']:.3f}; one auto step's device "
        f"time (the kernel census) {dev_ms:.3f} ms, of which K6 {k6_ms:.3f} "
        f"ms -> idle share "
        + (f"{result['idle_share']:.4f}" if dev_ms > 0 else "not measured"))
    return result, launches


def phase_times_gelu_dropout(torch, cases):
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb

    for c in cases:
        key, p = c["key"], c["p"]
        numel = c["u"].numel()

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
        c["bound_ms"], c["bound_by"] = bound(
            *fb.gd_cost(numel, c["u"].dtype), "float32")
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
            *fb.gd_cost(numel, c["u"].dtype, bwd=True), "float32")
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
        grads_to_none(enc)
        mxrandom.seed(ND_SEED)
        with mx.autograd.pause(train_mode=p > 0):
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


# ---------------------------------------------------------------------------
# [gluon]: the reference's gluon training loop on the card
# ---------------------------------------------------------------------------

# the reference's quick-start training script (the README's), with the
# package's name changed and nothing else
VERIFY_SCRIPT = '''
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import np, autograd, gluon
net = gluon.nn.HybridSequential()
net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(10))
net.initialize(); net.hybridize()
trainer = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
x, y = np.random.uniform(size=(64, 20)), np.random.randint(0, 10, (64,))
with autograd.record():
    loss = loss_fn(net(x), y)
loss.backward(); trainer.step(64)
print(float(loss.mean().item()))
'''
VERIFY_MORE = 20          # steps after the script's one
GLUON_STEPS = 3           # gluon-vs-module steps a mode (one of them warm)
GLUON_HYB_STEPS = 6       # hybridized steps: eager, capturing, replays
GLUON_DP_STEPS = 5        # DataParallel steps a rule: eager, capture, replays
GLUON_SEED = 41
# optimizer rules on the card against the CPU, 3 updates of a (256, 768)
# weight: 1e-6 of the weight's largest magnitude (f32), 1e-5 where the
# rule takes a norm
GLUON_OPT_TOL, GLUON_OPT_NORM_TOL = 1e-6, 1e-5
GLUON_OPT_CASES = (
    ("SGD", dict(momentum=0.9)), ("NAG", dict(momentum=0.9)), ("Adam", {}),
    ("AdamW", {}), ("AdaBelief", {}), ("AdaDelta", {}), ("AdaGrad", {}),
    ("Adamax", {}), ("DCASGD", dict(momentum=0.9)), ("FTML", {}),
    ("FTRL", {}), ("LAMB", {}), ("LANS", {}), ("LARS", {}), ("Nadam", {}),
    ("RMSProp", dict(centered=True)), ("Signum", {}), ("GroupAdaGrad", {}))


def phase_gluon_verify(torch, dev):
    """The verify script as written on cuda:0 (no scope open), then
    ``VERIFY_MORE`` more steps of its loop: the loss must fall, and the
    hybridized net captures its recorded signature once."""
    scope = {}
    exec(compile(VERIFY_SCRIPT, "verify_script", "exec"), scope)
    loss, net = scope["loss"], scope["net"]
    first = float(loss.mean().item())
    check(loss._data.device == dev and math.isfinite(first),
          f"[gluon] the verify script's loss is {first} on "
          f"{loss._data.device}")
    losses = [first]
    for _ in range(VERIFY_MORE):
        with scope["autograd"].record():
            loss = scope["loss_fn"](net(scope["x"]), scope["y"])
        loss.backward()
        scope["trainer"].step(64)
        losses.append(float(loss.mean().item()))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < first,
          f"[gluon] the verify script's loss did not fall: {losses}")
    check(net.captures == 1, f"[gluon] the verify net captured "
          f"{net.captures} graphs, expected 1 (its recorded signature)")
    log(f"[gluon] the verify script on {dev}: loss {first:.6f}, after "
        f"{VERIFY_MORE} more steps {losses[-1]:.6f}; captures "
        f"{net.captures}")
    return dict(first_loss=first, last_loss=losses[-1], losses=losses,
                captures=net.captures)


def _gluon_batch(torch, dev, mx):
    g = torch.Generator(device=dev).manual_seed(GLUON_SEED)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    return tokens, labels, mx.nd.array(tokens), mx.nd.array(labels)


def _gluon_pair(mx, dev, p):
    """A module-path BERT-base (seeded) and a gluon one made with
    ``initialize()``, the module path's weights carried into it by
    ``load_dict``."""
    from incubator_mxnet_tpu_torch.models.bert import bert_base

    mod = bert_base(max_length=TRAIN_T, dropout=p, device=dev, seed=0)
    glu = bert_base(max_length=TRAIN_T, dropout=p, device=dev)
    mx.random.seed(GLUON_SEED)
    glu.initialize()
    glu.load_dict({n: q.data()._data
                   for n, q in mod.collect_params().items()})
    return mod, glu


def _same_params(a, b):
    import torch

    return all(torch.equal(x.data()._data, y.data()._data)
               for x, y in zip(a.collect_params().values(),
                               b.collect_params().values()))


def _median(v):
    v = sorted(v)
    return v[len(v) // 2 - 1] / 2 + v[len(v) // 2] / 2 if len(v) % 2 == 0 \
        else v[len(v) // 2]


def _profiled_ms(torch, step):
    """Device busy ms of one ``step()`` (the kernel census, held: a
    step may be a graph's replay)."""
    return census_ms(profiled(torch, step))


def phase_gluon_bert(torch, dev, mx):
    """BERT-base at 64 x 128 through the gluon loop (NDArrays, record(),
    Trainer by name "adam") against the module path on the same weights
    and keys, in f32 at p = 0 and 0.1 and under AMP: losses, every
    gradient and every parameter bit for bit, launches per step. Returns
    (numbers, launches, by layout, the AMP steps' walls by path)."""
    from incubator_mxnet_tpu_torch import amp, autograd, gluon

    tokens, labels, tok_nd, lab_nd = _gluon_batch(torch, dev, mx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    res, launches, by_layout, walls = {}, {}, {}, {}

    def module_step(model, trainer):
        grads_to_none(model)
        with autograd.train_mode():
            loss = ce(model(tokens)[0], labels)
        loss.backward(torch.ones_like(loss))
        trainer.step(TRAIN_B)
        return loss.detach()

    def gluon_step(net, trainer):
        with autograd.record():
            loss = ce(net(tok_nd)[0], lab_nd)
        loss.backward()
        trainer.step(TRAIN_B)
        return loss._data.detach()

    for mode, p in (("f32", 0.0), ("f32", TRAIN_P), ("amp", TRAIN_P)):
        tag = f"{mode} p={p:g}"
        mod, glu = _gluon_pair(mx, dev, p)
        check(_same_params(mod, glu), f"[gluon {tag}] load_dict did not "
              f"carry the weights")
        tm = gluon.Trainer(mod.collect_params(), "adam",
                           {"learning_rate": TRAIN_LR})
        tg = gluon.Trainer(glu.collect_params(), "adam",
                           {"learning_rate": TRAIN_LR})
        if mode == "amp":
            amp.init("bfloat16")
        try:
            exact, counts, layouts, w = True, [], [], {"module": [],
                                                       "gluon": []}
            for i in range(GLUON_STEPS):
                out = {}
                for path, fn, model, trainer in (
                        ("module", module_step, mod, tm),
                        ("gluon", gluon_step, glu, tg)):
                    mx.random.seed(GLUON_SEED + i)
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss = fn(model, trainer)
                    torch.cuda.synchronize()
                    w[path].append((time.perf_counter() - t0) * 1e3)
                    out[path] = (loss, read_counts(), read_layout_counts(),
                                 {n: q.data()._data.grad for n, q in
                                  model.collect_params().items()})
                (lm, cm, ym, gm), (lg, cg, yg, gg) = out["module"], \
                    out["gluon"]
                same_grads = all((gm[n] is None and gg[n] is None)
                                 or (gm[n] is not None and gg[n] is not None
                                     and torch.equal(gm[n], gg[n]))
                                 for n in gm)
                exact &= (torch.equal(lm, lg) and same_grads
                          and _same_params(mod, glu))
                check(cm == cg and ym == yg, f"[gluon {tag}] step {i}: "
                      f"launches {cg} (by layout {yg}) through the gluon "
                      f"loop, {cm} ({ym}) on the module path")
                counts.append(cg)
                layouts.append(yg)
        finally:
            amp.deinit()
        check(exact, f"[gluon {tag}] the gluon loop is not the module path "
              f"bit for bit")
        c = counts[-1]
        check(c["K1"] == 12 and c["K2"] == 36 and c["K3f"] == 24
              and c["K3b"] == 48, f"[gluon {tag}] launches a step {c}")
        if p == TRAIN_P:
            check(c == STEP_LAUNCHES, f"[gluon {tag}] launches a step {c}, "
                  f"expected {STEP_LAUNCHES}")
        if mode == "amp":
            check(layouts[-1] == AMP_LAYOUT_LAUNCHES, f"[gluon {tag}] "
                  f"launches by layout {layouts[-1]}")
            walls["module"], walls["gluon"] = w["module"], w["gluon"]
        for cn, ly in zip(counts, layouts):
            for k, n in cn.items():
                launches[k] = launches.get(k, 0) + n
            for k, v in ly.items():
                for name, n in v.items():
                    by_layout.setdefault(k, {})
                    by_layout[k][name] = by_layout[k].get(name, 0) + n
        log(f"[gluon {tag}] BERT-base {TRAIN_B} x {TRAIN_T}, {GLUON_STEPS} "
            f"steps of the gluon loop (NDArrays, record(), Trainer 'adam') "
            f"against the module path from the same weights and keys: "
            f"losses, gradients and parameters bit for bit; launches a "
            f"step {c}; step ms gluon "
            + ", ".join(f"{v:.1f}" for v in w["gluon"]) + "; module "
            + ", ".join(f"{v:.1f}" for v in w["module"]))
        res[tag] = dict(steps=GLUON_STEPS, bit_for_bit=exact,
                        launches_per_step=c, gluon_ms=w["gluon"],
                        module_ms=w["module"])
        del mod, glu, tm, tg
        torch.cuda.empty_cache()
    return res, launches, by_layout, walls


def phase_gluon_hybrid(torch, dev, mx):
    """hybridize() under AMP at p = 0.1: the first call of the recorded
    signature eager, the second captured, the rest replayed; each step
    (forward replay, backward replay, Trainer) bit for bit the same
    function run eagerly with the same key on a twin net; two replays
    draw different masks; predict-mode calls a signature of their own;
    one capture a signature; step times and the device's idle share of
    the gluon loop eager, hybridized and the module path."""
    from incubator_mxnet_tpu_torch import amp, autograd, gluon
    from incubator_mxnet_tpu_torch.gluon.block import _CachedGraph

    tokens, labels, tok_nd, lab_nd = _gluon_batch(torch, dev, mx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    _, hyb = _gluon_pair(mx, dev, TRAIN_P)
    mod, ref = _gluon_pair(mx, dev, TRAIN_P)
    check(_same_params(hyb, ref), "[gluon hybrid] twins differ")
    hyb.hybridize(static_alloc=True, static_shape=True)
    th = gluon.Trainer(hyb.collect_params(), "adam",
                       {"learning_rate": TRAIN_LR})
    tr = gluon.Trainer(ref.collect_params(), "adam",
                       {"learning_rate": TRAIN_LR})
    twin = _CachedGraph(ref)
    amp.init("bfloat16")
    try:
        exact, walls, keys = True, [], []
        for i in range(GLUON_HYB_STEPS):
            mx.random.seed(GLUON_SEED + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                out = hyb(tok_nd)[0]
                loss = ce(out, lab_nd)
            loss.backward()
            th.step(TRAIN_B)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            replayed = [e for e in hyb._cached_graph.entries.values()
                        if e.fwd is not None]
            mx.random.seed(GLUON_SEED + i)
            with autograd.record():
                if replayed:   # the same captured function, eagerly
                    k = replayed[0].key.tolist()
                    keys.append(k)
                    ro = twin.eager((tok_nd,), k[:2], k[2])[0]
                else:          # the first call: eager on both
                    ro = ref(tok_nd)[0]
                rl = ce(ro, lab_nd)
            rl.backward()
            same = torch.equal(loss._data, rl._data) and all(
                torch.equal(a.data()._data.grad, b.data()._data.grad)
                for a, b in zip(hyb.collect_params().values(),
                                ref.collect_params().values())
                if b.data()._data.grad is not None)
            tr.step(TRAIN_B)
            exact &= same and _same_params(hyb, ref)
        check(exact, "[gluon hybrid] the replayed steps are not the eager "
              "steps with the same keys bit for bit")
        check(hyb.captures == 1, f"[gluon hybrid] {hyb.captures} captures "
              f"for one (mode, signature)")
        check(len({tuple(k) for k in keys}) == len(keys), "[gluon hybrid] "
              "replays reused a key")
        with autograd.record():
            a = hyb(tok_nd)[0]._data.clone()
            b = hyb(tok_nd)[0]._data
        masks_differ = not torch.equal(a, b)
        check(masks_differ, "[gluon hybrid] two replays drew the same masks")
        pred = [hyb(tok_nd)[0]._data.clone() for _ in range(3)]
        want = ref(tok_nd)[0]._data
        check(all(torch.equal(x, want) for x in pred) and hyb.captures == 2,
              f"[gluon hybrid] predict-mode calls: {hyb.captures} captures, "
              f"outputs equal to the eager net's: "
              f"{[torch.equal(x, want) for x in pred]}")
        del a, b, pred, want
        # the device's idle share of each path's step
        tm = gluon.Trainer(mod.collect_params(), "adam",
                           {"learning_rate": TRAIN_LR})

        def hyb_step():
            with autograd.record():
                loss = ce(hyb(tok_nd)[0], lab_nd)
            loss.backward()
            th.step(TRAIN_B)

        def eager_step():
            with autograd.record():
                loss = ce(ref(tok_nd)[0], lab_nd)
            loss.backward()
            tr.step(TRAIN_B)

        def module_step():
            grads_to_none(mod)
            with autograd.train_mode():
                loss = ce(mod(tokens)[0], labels)
            loss.backward(torch.ones_like(loss))
            tm.step(TRAIN_B)

        times = {}
        for name, fn in (("hybridized", hyb_step), ("eager", eager_step),
                         ("module", module_step)):
            fn()
            w = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                w.append((time.perf_counter() - t0) * 1e3)
            dev_ms = _profiled_ms(torch, fn)
            med = _median(w)
            times[name] = dict(step_ms=w, median_step_ms=med,
                               device_ms=dev_ms,
                               idle_share=1 - dev_ms / med
                               if dev_ms > 0 else None)
    finally:
        amp.deinit()
    for name, t in times.items():
        idle = t["idle_share"]
        log(f"[gluon hybrid] AMP {name} step: median {t['median_step_ms']:.2f}"
            f" ms, device busy {t['device_ms']:.2f} ms -> idle share "
            + (f"{idle:.4f}" if idle is not None else "not measured"))
    log(f"[gluon hybrid] AMP p={TRAIN_P:g}: {GLUON_HYB_STEPS} steps (eager, "
        f"capturing, replays) bit for bit the eager function with the same "
        f"keys (losses, gradients, parameters); {hyb.captures} captures "
        f"(record, predict); two replays' masks differ: {masks_differ}; "
        f"step ms " + ", ".join(f"{v:.1f}" for v in walls))
    out = dict(steps=GLUON_HYB_STEPS, bit_for_bit=exact,
               captures=hyb.captures, masks_differ=masks_differ,
               step_ms=walls, times=times)
    del hyb, ref, mod, th, tr, twin
    torch.cuda.empty_cache()
    return out


def phase_gluon_dp(torch, dev, mx):
    """`DataParallel` over the HybridBlock BERT-base with the optimizers
    made by name, "adamw" and "lamb", under AMP: one capture each, the
    replays bit for bit `_step_fn` run eagerly from the same state and
    seed on a twin net."""
    from incubator_mxnet_tpu_torch import amp, gluon, optimizer
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    tokens, labels, _, _ = _gluon_batch(torch, dev, mx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    res = {}
    from incubator_mxnet_tpu_torch.models.bert import bert_base

    def net():
        n = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev)
        mx.random.seed(GLUON_SEED)
        n.initialize()
        return n

    for name in ("adamw", "lamb"):
        nets = [net() for _ in range(2)]
        dps = [DataParallel(n, lambda out, y: ce(out[0], y),
                            optimizer.create(name, learning_rate=TRAIN_LR,
                                             wd=0.01)) for n in nets]
        amp.init("bfloat16")
        try:
            mx.random.seed(GLUON_SEED)
            walls, losses = [], []
            for _ in range(GLUON_DP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(dps[0].step(tokens, labels))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            mx.random.seed(GLUON_SEED)
            eager = [dps[1]._step_fn(*dps[1]._prepare(), tokens, labels)
                     for _ in range(GLUON_DP_STEPS)]
            exact = all(torch.equal(a, b) for a, b in zip(losses, eager)) \
                and all(torch.equal(a, b) for a, b in
                        zip(nets[0].parameters(), nets[1].parameters()))
            dev_ms = _profiled_ms(torch, lambda: dps[0].step(tokens, labels))
        finally:
            amp.deinit()
        check(exact and dps[0].captures == 1 and dps[1].captures == 0,
              f"[gluon dp {name}] captures {dps[0].captures}, replays bit "
              f"for bit the eager step: {exact}")
        vals = [v.item() for v in losses]
        check(all(math.isfinite(v) for v in vals),
              f"[gluon dp {name}] losses {vals}")
        med = _median(walls[2:])
        res[name] = dict(captures=dps[0].captures, bit_for_bit=exact,
                         elementwise=dps[0].optimizer.elementwise,
                         fused_params=len(dps[0]._fused), step_ms=walls,
                         median_replay_ms=med, device_ms=dev_ms,
                         idle_share=1 - dev_ms / med if dev_ms > 0 else None,
                         losses=vals)
        idle = res[name]["idle_share"]
        log(f"[gluon dp {name}] DataParallel over the HybridBlock BERT-base "
            f"(AMP, p={TRAIN_P:g}, optimizer.create({name!r})): 1 capture, "
            f"{GLUON_DP_STEPS} steps bit for bit `_step_fn` eagerly; "
            f"small-parameter segment {len(dps[0]._fused)} parameters; "
            f"replay median {med:.2f} ms, device busy {dev_ms:.2f} ms -> "
            f"idle share "
            + (f"{idle:.4f}" if idle is not None else "not measured"))
        del nets, dps
        torch.cuda.empty_cache()
    return res


def phase_gluon_optimizers(torch, dev, mx):
    """Each ported rule (SGLD's noise aside) on the card against its CPU
    result on the same numpy inputs: 3 updates of a (256, 768) weight
    with rescale_grad, clip_gradient and weight decay."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import optimizer

    r = onp.random.RandomState(GLUON_SEED)
    w0 = r.normal(0, 1, (256, 768)).astype("float32")
    grads = [r.normal(0, 1, (256, 768)).astype("float32")
             for _ in range(3)]
    res = {}
    for cls, kw in GLUON_OPT_CASES:
        out = {}
        for where in ("cpu", dev):
            opt = getattr(optimizer, cls)(learning_rate=0.01,
                                          rescale_grad=0.5,
                                          clip_gradient=1.5, wd=0.01, **kw)
            w = torch.from_numpy(w0.copy()).to(where)
            state = opt.create_state(0, w)
            for g in grads:
                opt.update(0, w, torch.from_numpy(g).to(where), state)
            out[str(where)] = w.cpu()
        want, got = out["cpu"], out[str(dev)]
        err = ((got - want).abs().max() / want.abs().max()).item()
        tol = GLUON_OPT_NORM_TOL if cls in ("LAMB", "LANS", "LARS") \
            else GLUON_OPT_TOL
        check(err <= tol, f"[gluon opt] {cls} on the card is {err:.2e} of "
              f"the weight's largest magnitude from the CPU (tol {tol:g})")
        res[cls] = err
    log("[gluon opt] rules on the card vs the CPU, max |d| / max |w| after "
        "3 updates: " + ", ".join(f"{k} {v:.1e}" for k, v in res.items()))
    return res


def phase_gluon(torch, dev, beside=None):
    """[gluon]: the reference's gluon loop on the card. ``beside``: the
    same run's [train amp] and [train dp amp] results, whose AMP step
    times are printed next to the gluon loop's."""
    import incubator_mxnet_tpu_torch as mx

    start = time.perf_counter()
    res = {"verify": phase_gluon_verify(torch, dev)}
    torch.cuda.empty_cache()
    res["bert"], launches, by_layout, _ = phase_gluon_bert(torch, dev, mx)
    res["hybrid"] = phase_gluon_hybrid(torch, dev, mx)
    res["dp"] = phase_gluon_dp(torch, dev, mx)
    res["optimizers"] = phase_gluon_optimizers(torch, dev, mx)
    mx.waitall()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - start
    t = res["hybrid"]["times"]
    rows = [(f"gluon loop, {k}", v["median_step_ms"], v["idle_share"])
            for k, v in t.items()]
    rows += [(f"gluon DataParallel {k}", v["median_replay_ms"],
              v["idle_share"]) for k, v in res["dp"].items()]
    for tag, r in (beside or {}).items():
        rows.append((tag, r["median_step_ms"], r["idle_share"]))
    res["amp_step_ms"] = {n: dict(median_ms=m, idle_share=i)
                          for n, m, i in rows}
    log("[gluon] AMP step times, BERT-base 64 x 128 (median ms, idle "
        "share): " + "; ".join(
            f"{n} {m:.2f} ({'not measured' if i is None else f'{i:.4f}'})"
            for n, m, i in rows))
    log(f"[gluon] launches through the gluon loop's eager steps: {launches};"
        f" {res['seconds']:.1f} s")
    return res, launches, by_layout


# -- [amp16]: BERT-base under amp.init("float16") ---------------------------

# the layouts the float16 AMP step's row kernels take, launches a step
# (the MLM LayerNorm f16 x with f32 gamma/beta; the encoder LayerNorm f32;
# every residual site f32 x with an f16 h): the bf16 AMP step's counts
AMP16_K3 = "f32 x, f16 h, f32 gamma"
AMP16_K4 = "f16 x, f32 gamma"
AMP16_LAYOUT_LAUNCHES = {"K4": {"f32": 1, AMP16_K4: 1},
                         "K4b": {"f32": 2, AMP16_K4: 2},
                         "K3f": {AMP16_K3: 24}, "K3b": {AMP16_K3: 48}}
# a float16 net (net.cast("float16")): every row kernel all-f16
F16_LAYOUT_LAUNCHES = {k: {"f16": sum(v.values())}
                       for k, v in AMP16_LAYOUT_LAUNCHES.items()}
AMP16_STEPS = 20
MP_STEPS = 10
# the kernels against the plain versions, one float16 AMP step at p = 0:
# both run the same cuBLAS products in f16; they differ where K1/K2 round
# P and dS at the running max (the plain version at the final max), in
# the row kernels' f32 sum orders, and from there through 12 layers of f16
# products. Loss within 2^-10 relative; the gradients (unscaled, f32)
# normwise within 2^-6 all together and 2^-3 each (a parameter whose
# gradient norm is at least 1e-3 of the largest); Adam's first step is
# about lr * sign(g): the parameters within 2 lr of each other, the
# update signs agreeing on at least 0.97 of the elements (the bf16 AMP
# test's rule, `tests/test_torch_amp.py`)
AMP16_LOSS_TOL, AMP16_GRAD_TOL, AMP16_GRAD_EACH_TOL = \
    2.0 ** -10, 2.0 ** -6, 2.0 ** -3
AMP16_SIGN_AGREE = 0.97


def _flash_dtypes(cen):
    """The element types of the flash kernels a census holds."""
    names = [r["name"] for r in cen["rows"] if "flash_" in r["name"]]
    return names, {("f16" if "__half" in n else "bf16" if "bfloat16" in n
                    else "f32") for n in names}


def _amp16_eager_vs_plain(torch, dev, tokens, labels, vl):
    """One float16 AMP step at p = 0, through the kernels and through the
    plain versions, from the same weights: loss, unscaled gradients,
    parameters after one Adam step."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam

    ce = SoftmaxCrossEntropyLoss()
    out = {}
    base = None
    for impl in ("auto", "plain"):
        model = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev,
                          seed=0, impl=impl)
        if base is None:
            base = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
        trainer = Trainer(model.collect_params(),
                          Adam(learning_rate=TRAIN_LR))
        amp.scale_loss._scaler = amp.LossScaler()
        amp.init("float16")
        try:
            with autograd.train_mode():
                loss = ce(model(tokens, None, vl)[0], labels)
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward(torch.ones_like(scaled))
        finally:
            amp.deinit()
        scale = amp.scale_loss._scaler.loss_scale
        grads = {n: p.grad.float() / scale
                 for n, p in model.named_parameters() if p.grad is not None}
        trainer.step(TRAIN_B)
        torch.cuda.synchronize()
        out[impl] = dict(loss=loss.mean().item(), grads=grads,
                         params={n: p.detach().clone()
                                 for n, p in model.named_parameters()})
        del model, trainer
    k, p = out["auto"], out["plain"]
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    finite = all(bool(torch.isfinite(g).all()) for g in k["grads"].values())
    num = sum(float((k["grads"][n] - g).norm() ** 2)
              for n, g in p["grads"].items())
    den = sum(float(g.norm() ** 2) for g in p["grads"].values())
    grad_rel = (num / den) ** 0.5
    top = max(float(g.norm()) for g in p["grads"].values())
    each = max(float((k["grads"][n] - g).norm() / g.norm())
               for n, g in p["grads"].items()
               if float(g.norm()) >= 1e-3 * top)
    step_ok, agree_n, total = True, 0, 0
    for n, w0 in base.items():
        wk, wp = k["params"][n], p["params"][n]
        step_ok &= bool(((wk - wp).abs() <= 2 * TRAIN_LR * (1 + 1e-5))
                        .all())
        agree_n += int((torch.sign(wk - w0) == torch.sign(wp - w0)).sum())
        total += w0.numel()
    agree = agree_n / total
    ok = (loss_rel <= AMP16_LOSS_TOL and finite and grad_rel <= AMP16_GRAD_TOL
          and each <= AMP16_GRAD_EACH_TOL and step_ok
          and agree >= AMP16_SIGN_AGREE)
    log(f"[amp16] one step at p = 0, kernels vs plain (same weights): loss "
        f"{k['loss']:.6f} vs {p['loss']:.6f}, rel {loss_rel:.3e} (tol "
        f"2^-10); gradients unscaled, all finite: {finite}, normwise "
        f"{grad_rel:.3e} together (tol 2^-6), at most {each:.3e} each "
        f"(tol 2^-3); after one Adam step every parameter within 2 lr: "
        f"{step_ok}, update signs agree on {agree:.5f} (tol "
        f"{AMP16_SIGN_AGREE}): {'ok' if ok else 'EXCEEDED'}")
    check(ok, "[amp16]: the float16 AMP step through the kernels "
          "disagrees with the plain versions")
    return dict(loss=k["loss"], plain_loss=p["loss"], loss_rel=loss_rel,
                grad_norm_rel=grad_rel, grad_each_rel=each,
                adam_within_2lr=step_ok, update_sign_agreement=agree)


def _scaled_loop(torch, model, trainer, tokens, labels, steps, what,
                 want_layout, amp16=True, after_step=None):
    """MXNet's float16 loop: ``scale_loss``, ``backward``,
    ``has_overflow``; on an overflow ``update_scale(True)`` and no step,
    else ``update_scale(False)``, ``trainer.step`` and ``after_step()``.
    The loss is taken of f32 scores; the forward and backward run under
    ``amp.init("float16")`` with ``amp16`` (else the model's own dtypes).
    Launches counted a step by kernel and layout. Returns (losses, step
    ms, overflows, scales)."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    ce = SoftmaxCrossEntropyLoss()
    amp.scale_loss._scaler = scaler = amp.LossScaler()
    params = model.collect_params()
    losses, times, overflows, scales = [], [], 0, []
    for i in range(steps):
        reset_counts()
        grads_to_none(model)
        torch.cuda.synchronize()
        start = time.perf_counter()
        if amp16:
            amp.init("float16")
        try:
            with autograd.train_mode():
                loss = ce(model(tokens)[0].float(), labels)
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward(torch.ones_like(scaled))
        finally:
            amp.deinit()
        scales.append(scaler.loss_scale)
        if scaler.has_overflow(params):
            scaler.update_scale(True)
            overflows += 1
        else:
            scaler.update_scale(False)
            trainer.step(TRAIN_B)
            if after_step is not None:
                after_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        losses.append(loss.float().mean().item())
        counts, layouts = read_counts(), read_layout_counts()
        check(counts == STEP_LAUNCHES and layouts == want_layout,
              f"{what} step {i}: launches {counts}, by layout {layouts}; "
              f"expected {STEP_LAUNCHES}, {want_layout}")
    return losses, times, overflows, scales


def phase_amp16(torch, dev, dp_amp):
    """[amp16]: BERT-base at 64 x 128, MLM CE, under amp.init("float16"):
    the step through the kernels against the plain versions at p = 0;
    20 steps at p = 0.1 in MXNet's dynamic-loss-scale loop (launches a
    step by layout, every flash kernel float16); the same model through
    `DataParallel` (one capture, replays bit for bit the eager step);
    and a float16 net (``net.cast("float16")``) through ``Trainer(...,
    {"multi_precision": True})``, each float16 weight its f32 master's
    cast after every step. ``dp_amp``: the same run's [train dp amp]."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam

    start_s = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    vl = torch.randint(TRAIN_T // 2, TRAIN_T + 1, (TRAIN_B,), generator=g,
                       device=dev)
    res = {"eager_vs_plain": _amp16_eager_vs_plain(torch, dev, tokens,
                                                   labels, vl)}
    torch.cuda.empty_cache()

    # the training loop, dropout 0.1
    model = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                      seed=0)
    trainer = Trainer(model.collect_params(), Adam(learning_rate=TRAIN_LR))
    n_params = sum(p.numel() for p in model.parameters())
    mxrandom.seed(0)
    losses, times, overflows, scales = _scaled_loop(
        torch, model, trainer, tokens, labels, AMP16_STEPS, "[amp16]",
        AMP16_LAYOUT_LAUNCHES)
    check(all(math.isfinite(v) for v in losses), "[amp16]: non-finite loss")
    check(sum(losses[-5:]) < sum(losses[:5]), "[amp16]: the loss did not "
          "fall")
    timed = sorted(times[WARMUP:])
    med = timed[len(timed) // 2 - 1] / 2 + timed[len(timed) // 2] / 2
    def fwd_bwd():
        grads_to_none(model)
        with autograd.train_mode():
            loss = SoftmaxCrossEntropyLoss()(model(tokens)[0], labels)
        loss.backward(torch.ones_like(loss))

    amp.init("float16")
    try:
        cen = profiled(torch, fwd_bwd)
    finally:
        amp.deinit()
    names, kinds = _flash_dtypes(cen)
    check(names and kinds == {"f16"}, f"[amp16]: flash kernels in the step "
          f"not all float16: {sorted(set(names))[:6]}")
    dev_ms = census_ms(cen)
    idle = 1 - dev_ms / med if dev_ms > 0 else None
    log(f"[amp16] BERT-base {TRAIN_B} x {TRAIN_T}, dropout {TRAIN_P}, Adam "
        f"lr {TRAIN_LR}, {n_params} parameters, amp.init('float16'), "
        f"scale_loss + has_overflow + update_scale: step ms "
        + ", ".join(f"{t:.1f}" for t in times) + "; loss "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; loss scale a step {scales}; {overflows} overflow(s) skipped")
    log(f"[amp16] launches per step {STEP_LAUNCHES}, by layout "
        f"{AMP16_LAYOUT_LAUNCHES}: every step as expected; the flash "
        f"kernels of a profiled forward and backward all float16 "
        f"({len(names)} records)")
    log(f"[amp16] median step {med:.2f} ms (loop with the overflow check), "
        f"{TRAIN_B * TRAIN_T / (med / 1e3):.1f} tokens/s; device busy "
        f"{dev_ms:.2f} ms of a forward and backward (the kernel census)")
    res["train"] = dict(losses=losses, step_ms=times, median_step_ms=med,
                        overflows=overflows, loss_scales=scales,
                        fwd_bwd_device_ms=dev_ms, idle_share=idle,
                        launches_per_step=STEP_LAUNCHES,
                        launches_by_layout_per_step=AMP16_LAYOUT_LAUNCHES)
    launches = {k: v * AMP16_STEPS for k, v in STEP_LAUNCHES.items()}
    layouts = {k: {n: c * AMP16_STEPS for n, c in v.items()}
               for k, v in AMP16_LAYOUT_LAUNCHES.items()}
    del model, trainer, cen
    torch.cuda.empty_cache()

    # DataParallel, the same model under float16 AMP
    dp_res, (dp_launches, dp_layouts) = phase_train_dp(
        torch, dev, dict(median_step_ms=med,
                         tokens_per_s=TRAIN_B * TRAIN_T / (med / 1e3),
                         device_ms_per_step=dev_ms, idle_share=idle),
        "amp16")
    res["dp"] = dp_res
    # the idle share of a replay from CUDA events: 1 - its span on the card
    # over the step's median wall (the profiler's device sum of a replay
    # counts its span twice, PERF.md §7)
    idle16 = 1 - dp_res["replay_span_ms"] / dp_res["median_step_ms"]
    idle_bf16 = 1 - dp_amp["replay_span_ms"] / dp_amp["median_step_ms"]
    res["dp_idle_share_events"] = dict(float16=idle16, bfloat16=idle_bf16)
    log(f"[amp16] DataParallel replay: median {dp_res['median_step_ms']:.2f}"
        f" ms, span {dp_res['replay_span_ms']:.2f} ms on the card, idle "
        f"share {idle16:.4f} (CUDA events); [train dp amp] (bf16) of this "
        f"run: median {dp_amp['median_step_ms']:.2f} ms, span "
        f"{dp_amp['replay_span_ms']:.2f} ms, idle share {idle_bf16:.4f}")
    for k, n in dp_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in dp_layouts.items():
        for name, n in v.items():
            layouts[k][name] = layouts[k].get(name, 0) + n
    torch.cuda.empty_cache()

    # a float16 net with f32 master weights
    net = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev, seed=0)
    net.cast("float16")
    mp_trainer = Trainer(net.collect_params(), "adam",
                         {"learning_rate": TRAIN_LR,
                          "multi_precision": True})
    params = sorted(net.collect_params().items())
    exact = []

    def masters_exact():
        ok = True
        for i, (_, prm) in enumerate(params):
            st = mp_trainer._states[i]
            if st is None:
                continue
            ok &= (isinstance(st, tuple)
                   and st[0].dtype == torch.float32
                   and torch.equal(prm._data._data, st[0].half()))
        return ok

    mxrandom.seed(1)
    mp_losses, _, mp_overflows, _ = _scaled_loop(
        torch, net, mp_trainer, tokens, labels, MP_STEPS,
        "[amp16] multi-precision", F16_LAYOUT_LAUNCHES, amp16=False,
        after_step=lambda: exact.append(masters_exact()))
    for k, n in STEP_LAUNCHES.items():
        launches[k] = launches.get(k, 0) + n * MP_STEPS
    for k, v in F16_LAYOUT_LAUNCHES.items():
        for name, n in v.items():
            layouts[k][name] = layouts[k].get(name, 0) + n * MP_STEPS
    check(all(math.isfinite(v) for v in mp_losses) and exact and all(exact),
          f"[amp16] multi-precision: losses {mp_losses}, every float16 "
          f"weight its master's cast after each step: {exact}")
    check(sum(mp_losses[-3:]) < sum(mp_losses[:3]),
          "[amp16] multi-precision: the loss did not fall")
    log(f"[amp16] net.cast('float16') + Trainer('adam', multi_precision): "
        f"loss " + ", ".join(f"{v:.4f}" for v in mp_losses)
        + f"; {mp_overflows} overflow(s) skipped; after each of "
        f"{len(exact)} steps every float16 weight equals its f32 master's "
        f"cast bit for bit; the row kernels all-f16 ({F16_LAYOUT_LAUNCHES} "
        f"a step)")
    res["multi_precision"] = dict(losses=mp_losses, overflows=mp_overflows,
                                  masters_exact=all(exact))
    res["seconds"] = time.perf_counter() - start_s
    del net, mp_trainer
    return res, launches, layouts


# -- [dense]: BERT's dense-mask path, BERTClassifier, GPT's untied head -------

# the dense path against the flash path on the same weights, p = 0: f32
# (both f32-accurate: cuBLAS in full f32, the flash kernels 3xTF32) the
# scores and every gradient within 1e-3 of their largest magnitude (12
# layers, sums in other orders); under bf16 AMP the dense path rounds the
# scores to bf16 (its batch_dot's output, as the reference's) where the
# flash kernels keep them f32, so normwise 2^-4 for the scores and the
# gradients together (each side lies about that far from its f32 run,
# `tests/test_torch_amp.py`)
DENSE_F32_TOL = 1e-3
DENSE_AMP_TOL = 2.0 ** -4
DENSE_STEPS, CLASSIFIER_STEPS = 5, 10


def _dense_pair_step(torch, models, tokens, labels, vl, target=None):
    """Scores and gradients of one MLM step of each model."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    out = []
    for model in models:
        grads_to_none(model)
        if target:
            amp.init(target)
        try:
            with autograd.train_mode():
                scores = model(tokens, None, vl)[0]
                loss = SoftmaxCrossEntropyLoss()(scores, labels)
            loss.backward(torch.ones_like(loss))
        finally:
            amp.deinit()
        out.append((scores.detach().float(),
                    {n: p.grad.float() for n, p in model.named_parameters()
                     if p.grad is not None}))
    return out


def phase_dense(torch, dev):
    """[dense]: BERT-base ``use_flash=False`` at 64 x 128 with ragged
    valid_length against the flash model on the same weights (f32 and
    bf16 AMP, p = 0), its K5 launches on the probabilities at p = 0.1 and
    both paths' step times; BERTClassifier over that encoder, 10
    fine-tuning steps; gpt2_small with ``tie_weights=False`` and its head
    set to the embedding's copy through ``GPTModel.generate`` and a
    ``ServeEngine``, the tied model's tokens, one decode capture, and a
    recapture after a new tensor is bound to ``lm_head.weight``."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import (BERTClassifier,
                                                        bert_base)
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.optimizer import Adam

    start_s = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    vl = torch.randint(TRAIN_T // 4, TRAIN_T + 1, (TRAIN_B,), generator=g,
                       device=dev)
    res = {}
    flash = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=0)
    dense = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=0,
                      use_flash=False)
    dense.load_state_dict(flash.state_dict())
    for mode, target in (("f32", None), ("amp", "bfloat16")):
        reset_counts()
        (sd, gd), (sf, gf) = _dense_pair_step(torch, (dense, flash), tokens,
                                              labels, vl, target)
        torch.cuda.synchronize()
        counts = read_counts()
        if mode == "f32":
            err = (sd - sf).abs().max().item() / sf.abs().max().item()
            gerr = max(((gd[n] - v).abs().max() / v.abs().max()
                        .clamp_min(1e-30)).item() for n, v in gf.items())
            ok = err <= DENSE_F32_TOL and gerr <= DENSE_F32_TOL
            tol = f"1e-3 of the largest magnitude"
        else:
            err = ((sd - sf).norm() / sf.norm()).item()
            num = sum(float((gd[n] - v).norm() ** 2) for n, v in gf.items())
            gerr = (num / sum(float(v.norm() ** 2)
                              for v in gf.values())) ** 0.5
            ok = err <= DENSE_AMP_TOL and gerr <= DENSE_AMP_TOL
            tol = "2^-4 normwise"
        check(sorted(gd) == sorted(gf), f"[dense] {mode}: gradients of "
              f"other parameters")
        # the flash model's call launched K1/K2; the dense one none
        check(counts["K1"] == 12 and counts["K2"] == 36,
              f"[dense] {mode}: launches {counts}")
        log(f"[dense] {mode} p=0, {TRAIN_B} x {TRAIN_T}, ragged valid_length"
            f" ({int(vl.min())}..{int(vl.max())}): dense path vs the flash "
            f"path on the same weights: MLM scores {err:.3e}, gradients "
            f"{gerr:.3e} ({tol}: {'ok' if ok else 'EXCEEDED'}); launches of "
            f"both steps {counts} (K1/K2 the flash model's only)")
        check(ok, f"[dense] {mode}: the dense path disagrees with the flash "
              f"path")
        res[mode] = dict(score_err=err, grad_err=gerr)
    del flash
    torch.cuda.empty_cache()

    # dropout 0.1: K5 on the probabilities (N*H, T, T) at every layer
    shapes = []
    kernel = dp._kernel

    def recording(x, key, p):
        shapes.append(tuple(x.shape))
        return kernel(x, key, p)

    dp._kernel = recording
    try:
        dense_p = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                            seed=0, use_flash=False)
        mxrandom.seed(0)
        reset_counts()
        _dense_pair_step(torch, (dense_p,), tokens, labels, vl)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        dp._kernel = kernel
    probs = sum(s == (TRAIN_B * H, TRAIN_T, TRAIN_T) for s in shapes)
    want = dict(STEP_LAUNCHES, K1=0, K2=0)
    check(counts == want and probs == 24,
          f"[dense] p={TRAIN_P}: launches {counts} (expected {want}), K5 on "
          f"the probabilities {probs} times (expected 12 forward + 12 "
          f"backward)")
    res["launches_p01_step"] = dense_launches = counts
    log(f"[dense] p={TRAIN_P}: launches a step {counts}; K5 on the "
        f"({TRAIN_B * H}, {TRAIN_T}, {TRAIN_T}) probabilities {probs} times "
        f"(12 forward, 12 backward)")

    # both paths' step times under bf16 AMP at p = 0.1, Trainer("adam")
    times = {}
    for name, use_flash in (("dense", False), ("flash", True)):
        model = dense_p if not use_flash else bert_base(
            max_length=TRAIN_T, dropout=TRAIN_P, device=dev, seed=0)
        trainer = Trainer(model.collect_params(),
                          Adam(learning_rate=TRAIN_LR))
        walls = []
        for _ in range(WARMUP + DENSE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _dense_pair_step(torch, (model,), tokens, labels, vl,
                             "bfloat16")
            trainer.step(TRAIN_B)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        timed = sorted(walls[WARMUP:])
        times[name] = timed[len(timed) // 2]
        del trainer
        if use_flash:
            del model
    log(f"[dense] step under bf16 AMP at p={TRAIN_P}, {TRAIN_B} x "
        f"{TRAIN_T}, Trainer('adam'), median of {DENSE_STEPS}: dense "
        f"{times['dense']:.2f} ms, flash {times['flash']:.2f} ms")
    res["step_ms"] = times
    torch.cuda.empty_cache()

    # BERTClassifier over the dense encoder, 10 fine-tuning steps
    clf = BERTClassifier(dense_p.encoder, 2, dropout=TRAIN_P, seed=4)
    y = torch.randint(0, 2, (TRAIN_B,), generator=g, device=dev)
    trainer = Trainer(clf.collect_params(), "adam",
                      {"learning_rate": TRAIN_LR})
    ce = SoftmaxCrossEntropyLoss()
    clf_losses = []
    mxrandom.seed(2)
    for _ in range(CLASSIFIER_STEPS):
        grads_to_none(clf)
        with autograd.train_mode():
            loss = ce(clf(tokens, None, vl), y)
        loss.backward(torch.ones_like(loss))
        trainer.step(TRAIN_B)
        clf_losses.append(loss.mean().item())
    check(all(math.isfinite(v) for v in clf_losses)
          and sum(clf_losses[-3:]) < sum(clf_losses[:3]),
          f"[dense] BERTClassifier: the loss did not fall: {clf_losses}")
    log(f"[dense] BERTClassifier(2 classes, dropout {TRAIN_P}) over the "
        f"dense encoder, {CLASSIFIER_STEPS} Adam steps on one batch: loss "
        + ", ".join(f"{v:.4f}" for v in clf_losses))
    res["classifier_losses"] = clf_losses
    del clf, trainer, dense, dense_p
    torch.cuda.empty_cache()

    # gpt2_small with its own head, set to a copy of the embedding
    tied = gpt2_small(device=dev, seed=0).eval()
    untied = gpt2_small(device=dev, seed=0, tie_weights=False).eval()
    own = untied.collect_params()
    for n, prm in tied.collect_params().items():
        own[n].set_data(prm._data._data)
    untied.lm_head.weight.set_data(tied.word_embed.weight._data._data.clone())
    batch, t0, new = REQUESTS[0]
    prompt = torch.randint(0, VOCAB, (batch, t0), generator=g, device=dev)
    with torch.no_grad():
        a = untied.generate(prompt, new)
        b = tied.generate(prompt, new)
    same_gen = torch.equal(a, b)
    check(same_gen, "[dense] untied GPT: generate differs from the tied "
          "model's")
    prompts, budgets, _ = _serve_trace_a(onp)
    outs, engines = [], []
    for model in (untied, tied):
        e = serve.ServeEngine(model, max_slots=SERVE_SLOTS,
                              max_len=SERVE_MAX_LEN)
        handles = [e.submit(p, n) for p, n in zip(prompts[:8], budgets[:8])]
        e._drive_until(handles)
        outs.append([list(h.result()) for h in handles])
        engines.append(e)
    slots = engines[0]._sched.slots
    captures = dict(slots.captures_by_step)
    same_serve = outs[0] == outs[1]
    # a new tensor bound to lm_head.weight: the decode graph is captured
    # again at the next step, and the tokens stay the tied model's
    untied.lm_head.weight._bind(untied.lm_head.weight._data._data.clone())
    again = engines[0].generate(prompts[0], budgets[0])[len(prompts[0]):]
    recaptured = slots.captures_by_step["decode"]
    same_after = list(again) == outs[1][0]
    for e in engines:
        e.shutdown(drain=False)
    check(same_serve and captures["decode"] == 1 and recaptured == 2
          and same_after,
          f"[dense] untied GPT engine: tokens equal {same_serve}, decode "
          f"captures {captures} then {recaptured} after the swap, tokens "
          f"after the swap equal {same_after}")
    log(f"[dense] gpt2_small(tie_weights=False), lm_head = a copy of the "
        f"embedding: generate {batch} x {t0} -> {new} new tokens equal the "
        f"tied model's: {same_gen}; ServeEngine over trace A's first 8 "
        f"requests: tokens equal the tied engine's: {same_serve}, decode "
        f"captured {captures['decode']} time(s); a new tensor bound to "
        f"lm_head.weight: captured again ({recaptured}), tokens still "
        f"equal: {same_after}")
    res["gpt_untied"] = dict(generate_equal=same_gen,
                             engine_equal=same_serve,
                             decode_captures=captures["decode"],
                             recaptures_after_swap=recaptured - 1)
    res["seconds"] = time.perf_counter() - start_s
    del tied, untied, engines
    torch.cuda.empty_cache()
    return res, dense_launches


# ---------------------------------------------------------------------------
# [vision]: bench.py's ResNet-50-v1 training and the vision zoo on the card
# ---------------------------------------------------------------------------

VISION_B = 128                  # bench.py:310's batch, 3 x 224 x 224
VISION_SIZE = 224
VISION_WARMUP, VISION_STEPS = 2, 20
VISION_CHECK_B = 4              # the step held against the CPU's
VISION_REPLAY_STEPS = 5         # eager, capturing, 3 replays (lr 0)
VISION_GLUON_STEPS = 3
VISION_LOSS_TOL = 1e-4          # relative: the card's f32 loss, the CPU's
VISION_GRAD_ERR_X = 3.0         # a gradient's distance from the CPU's
#                                 float64 one: at most 3 x the CPU float32
#                                 run's own, + 1e-4 of its norm, + 1e-6 an
VISION_GRAD_ATOL = 1e-6         # element (a conv bias ahead of a BatchNorm:
#                                 its gradient is 0 up to rounding)
VISION_STAT_TOL = 1e-4          # of each statistic's largest entry
VISION_LOGIT_TOL = 1e-4         # of the largest logit
VISION_FAMILIES = (("alexnet", 224), ("resnet18_v1", 224),
                   ("resnet18_v2", 224), ("vgg11", 224), ("vgg11_bn", 224),
                   ("mobilenet0.25", 224), ("mobilenetv2_0.25", 224),
                   ("squeezenet1.1", 224), ("densenet121", 224),
                   ("inceptionv3", 299))
VISION_FAMILY_B = 8
VISION_DIGITS_N = 64
ALEXNET_K5_PER_STEP = 4         # 2 Dropout(0.5) sites, forward and backward
# peak rates of the model-FLOPs share (PERF.md §2): f32 FMA, dense bf16
VISION_PEAK = {"f32": 67e12, "bf16": 989e12}


def _vision_macs(net, x):
    """Forward multiply-adds of one call of ``net`` on ``x``, from its
    convolutions' and dense layers' own shapes (forward hooks): a
    convolution's output elements a filter times the filter's size, a
    dense layer's rows times its weight's size."""
    from incubator_mxnet_tpu_torch.gluon import nn

    total = [0]

    def hook(block, args, out):  # noqa: ARG001
        w = block.weight.data()
        w = getattr(w, "_data", w)
        if isinstance(block, nn.Dense):
            total[0] += out.shape[0] * w.numel()
        else:
            n_out = math.prod(out.shape)
            total[0] += n_out // block._channels * w.numel()

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if type(m).__name__ in ("Conv2D", "Dense")]
    try:
        net(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def _vision_cpu_net(mx, make, size, seed):
    """``make()`` on the CPU, initialised from ``seed`` and called once
    (deferred shapes)."""
    import torch

    with mx.cpu():
        mx.random.seed(seed)
        net = make()
        net.initialize()
        net(torch.zeros(1, 3, size, size))
    return net


def _vision_on(mx, net, device):
    import copy

    twin = copy.deepcopy(net)
    twin.reset_device(device)
    return twin


def _stats(net):
    return {k: p.data()._data.detach().clone()
            for k, p in net.collect_params().items() if "running" in k}


def _rel_max(got, ref):
    scale = max(float(ref.abs().max()), 1e-30)
    return float((got.double() - ref.double()).abs().max()) / scale


_VISION_CLASSES = (
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad",
                     "dgrad", "winograd", "fft", "sm90_", "sm80_")),
    ("batch_norm", ("batch_norm", "batchnorm", "welford")),
    ("cast_copy", ("copy", "cast", "to_copy", "fill")),
)


def _vision_profile(torch, step):
    """Device ms of one ``step()`` (a replay) by kernel class
    (convolutions and products, BatchNorm, casts and copies, the rest)
    and its six longest kernels, from the kernel census (`profiled`,
    held)."""
    # a trace with no device records (PERF.md §7) is taken again, at most
    # three times
    for _ in range(3):
        cen = profiled(torch, step)
        out = {name: 0.0 for name, _ in _VISION_CLASSES}
        out["other"] = 0.0
        for r in cen["rows"]:
            key = r["name"].lower()
            cls = next((name for name, parts in _VISION_CLASSES
                        if any(p in key for p in parts)), "other")
            out[cls] += r["time_us"] / 1e3
        out["total"] = sum(v for k, v in out.items())
        if out["total"] > 0:
            break
    out["top"] = [(round(r["time_us"] / 1e3, 3), r["count"], r["name"][:90])
                  for r in cen["rows"][:6]]
    return out


def phase_vision_bench(torch, dev, mode):
    """`bench.py:310` (`bench_resnet50_train`) as written, on the port:
    `resnet50_v1()`, ``initialize()``, one call at 1 x 3 x 224 x 224,
    `DataParallel` with `SoftmaxCrossEntropyLoss` and SGD (lr 0.01,
    momentum 0.9) on a batch of 128, 2 warm-up steps (eager, capturing)
    and 20 timed replays, in f32 (TF32 off) or under
    ``amp.init("bfloat16")``; then 20 more, each timed alone, for the
    median step; a replay's span on the card from CUDA events."""
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, gluon, np, optimizer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.parallel.sharded import DataParallel

    tag = f"vision {mode}"
    mx.random.seed(0)
    net = resnet50_v1()
    net.initialize()
    rng = onp.random.RandomState(0)
    x1 = np.array(rng.uniform(-1, 1, (1, 3, VISION_SIZE, VISION_SIZE))
                  .astype("float32"))
    macs = _vision_macs(net, x1)          # the bench's own first call
    dp = DataParallel(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                      optimizer.SGD(learning_rate=0.01, momentum=0.9))
    x = np.array(rng.uniform(-1, 1, (VISION_B, 3, VISION_SIZE, VISION_SIZE))
                 .astype("float32"))
    y = np.array(rng.randint(0, 1000, (VISION_B,)).astype("int32"))
    if mode == "bf16":
        amp.init("bfloat16")
    try:
        losses = []
        for _ in range(VISION_WARMUP):
            losses.append(dp.step(x, y))
        float(losses[-1].asnumpy())
        t0 = time.perf_counter()
        for _ in range(VISION_STEPS):
            losses.append(dp.step(x, y))
        float(losses[-1].asnumpy())
        dt = (time.perf_counter() - t0) / VISION_STEPS
        walls = []
        for _ in range(VISION_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dp.step(x, y)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        dp.step(x, y)
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end)
        split = _vision_profile(torch, lambda: dp.step(x, y))
    finally:
        amp.deinit()
    vals = [float(v.asnumpy()) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"{tag}: a non-finite loss")
    check(vals[-1] < vals[0], f"{tag}: the loss did not fall ({vals[0]} -> "
          f"{vals[-1]})")
    check(dp.captures == 1, f"{tag}: {dp.captures} captures, expected 1")
    med = _median(walls)
    flops = 6.0 * macs * VISION_B
    out = dict(batch=VISION_B, images_per_s=VISION_B / dt,
               images_per_s_median_step=VISION_B / (med / 1e3),
               median_step_ms=med, replay_device_ms=replay_ms,
               idle_share=1 - replay_ms / med, captures=dp.captures,
               macs_per_image=macs, flops_per_step=flops,
               flops_share=flops / (med / 1e3) / VISION_PEAK[mode],
               bound_ms=flops / VISION_PEAK[mode] * 1e3,
               loss_first=vals[0], loss_last=vals[-1])
    out["device_ms_by_class"] = split
    log(f"[{tag}] a profiled replay's device time by class: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()
                    if k != "top"))
    log(f"[{tag}] its longest kernels: {split['top']}")
    log(f"[{tag}] resnet50_v1 batch {VISION_B} x 3 x {VISION_SIZE}^2, SGD "
        f"lr 0.01 momentum 0.9, DataParallel (one CUDA graph, "
        f"{dp.captures} capture): {out['images_per_s']:.1f} images/s "
        f"(bench.py's timing, {VISION_STEPS} chained steps), median step "
        f"{med:.3f} ms ({out['images_per_s_median_step']:.1f} images/s), a "
        f"replay {replay_ms:.3f} ms on the card (CUDA events): idle share "
        f"{out['idle_share']:.4f}; {macs} forward multiply-adds an image, "
        f"{flops / 1e12:.4f} TFLOP a step: model FLOPs share "
        f"{out['flops_share']:.4f} of {VISION_PEAK[mode] / 1e12:.0f} "
        f"TFLOP/s (bound {out['bound_ms']:.3f} ms); loss {vals[0]:.4f} -> "
        f"{vals[-1]:.4f}")
    del dp, net, x, y, losses
    return out


def _vision_grads(torch, mx, net, xn, yn, device, dtype):
    """(loss, gradients on the CPU in float64, running statistics after)
    of one training forward and backward of ``net`` (its own device and
    dtype) on the batch; the autograd graph goes with the call, so no
    node of it (its streams) outlives it."""
    from incubator_mxnet_tpu_torch import autograd, gluon

    x = torch.from_numpy(xn).to(device=device, dtype=dtype)
    y = torch.from_numpy(yn).to(device)
    params = [p for p in net.parameters() if p.requires_grad]
    with autograd.train_mode():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y).mean()
        grads = torch.autograd.grad(loss, params)
    return (float(loss.detach()), [g.detach().double().cpu() for g in grads],
            {k: v.double().cpu() for k, v in _stats(net).items()})


def phase_vision_check(torch, dev):
    """ResNet-50-v1 at batch 4 x 3 x 224 x 224 on the card against the
    port's CPU run of the same weights and batch: the loss and the
    running statistics after the step against the CPU's float32 run, each
    gradient (normwise) against the CPU's float64 run, allowed
    ``VISION_GRAD_ERR_X`` times the CPU float32 run's own distance from
    it (a fresh ResNet-50's gradients at batch 4 are ill-conditioned:
    f32 rounding alone moves a BatchNorm's gamma gradient by ~2.6%
    normwise on the CPU) plus 1e-4 of its norm and 1e-6 an element; then
    one running-statistics update a step through `DataParallel` (eager,
    capturing, replays; SGD at lr 0, so each step sees the same batch
    statistics): after n steps rm = m^n rm0 + (1 - m^n) batch."""
    import copy

    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, optimizer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.parallel.sharded import DataParallel

    cpu = _vision_cpu_net(mx, resnet50_v1, VISION_SIZE, 1)
    card = _vision_on(mx, cpu, mx.gpu(0))
    cpu64 = copy.deepcopy(cpu)
    cpu64.cast("float64")
    rng = onp.random.RandomState(1)
    xn = rng.uniform(-1, 1, (VISION_CHECK_B, 3, VISION_SIZE, VISION_SIZE)) \
        .astype("float32")
    yn = rng.randint(0, 1000, (VISION_CHECK_B,)).astype("int32")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    cpu_dev = torch.device("cpu")
    lc, gc, sc = _vision_grads(torch, mx, cpu, xn, yn, cpu_dev,
                               torch.float32)
    l64, g64, _ = _vision_grads(torch, mx, cpu64, xn, yn, cpu_dev,
                                torch.float64)
    lg, gg, sg = _vision_grads(torch, mx, card, xn, yn, dev, torch.float32)
    loss_rel = abs(lg - lc) / abs(lc)
    names = [k for k, p in cpu.collect_params().items()
             if p.grad_req != "null"]
    worst, worst_name, worst_pair = 0.0, None, None
    for n, a, b, r in zip(names, gg, gc, g64):
        err = float((a - r).norm())
        own = float((b - r).norm())
        allowed = VISION_GRAD_ERR_X * own + 1e-4 * float(r.norm()) \
            + VISION_GRAD_ATOL * math.sqrt(r.numel())
        if err / allowed > worst:
            worst, worst_name = err / allowed, n
            worst_pair = (err / max(float(r.norm()), 1e-30),
                          own / max(float(r.norm()), 1e-30))
    stat_err = max(_rel_max(sg[k], sc[k]) for k in sc)
    log(f"[vision check] resnet50_v1 batch {VISION_CHECK_B}, one training "
        f"forward and backward, card (f32, TF32 off) against the CPU, same "
        f"weights and batch: loss {lg:.6f} vs {lc:.6f} (rel {loss_rel:.2e}, "
        f"tol {VISION_LOSS_TOL}; float64 {l64:.6f}); {len(gg)} gradients "
        f"against the CPU's float64, the worst {worst_name} at "
        f"{worst:.3f} of its allowance ({VISION_GRAD_ERR_X} x the CPU "
        f"float32's own distance + 1e-4 of the norm + "
        f"{VISION_GRAD_ATOL} an element; normwise "
        f"{worst_pair[0]:.2e} card, {worst_pair[1]:.2e} CPU float32); "
        f"{len(sc)} running statistics after the step within "
        f"{stat_err:.2e} of their largest entry (tol {VISION_STAT_TOL})")
    check(loss_rel <= VISION_LOSS_TOL, "vision check: loss")
    check(worst <= 1.0, f"vision check: gradient {worst_name}")
    check(stat_err <= VISION_STAT_TOL, "vision check: running statistics")
    del cpu64

    # one update a step: eager, capturing, replays
    m = 0.9
    twin = _vision_on(mx, card, dev)
    before = _stats(card)
    xs = torch.from_numpy(xn).to(dev)
    ys = torch.from_numpy(yn).to(dev)
    with autograd.train_mode():
        twin(xs)                                # one update, eagerly
    one = _stats(twin)
    dp = DataParallel(card, loss_fn, optimizer.SGD(learning_rate=0.0,
                                                   momentum=0.9))
    for _ in range(VISION_REPLAY_STEPS):
        dp.step(xs, ys)
    torch.cuda.synchronize()
    after = _stats(card)
    n = VISION_REPLAY_STEPS
    worst_upd = 0.0
    for k, v1 in one.items():
        rm0 = before[k]
        # v1 = m rm0 + (1 - m) batch: after n steps m^n rm0 + (1 - m^n) batch
        batch = (v1 - m * rm0) / (1 - m)
        want = m ** n * rm0 + (1 - m ** n) * batch
        worst_upd = max(worst_upd, _rel_max(after[k], want))
    log(f"[vision check] DataParallel, {n} steps (eager, capturing, "
        f"{n - 2} replays; {dp.captures} capture): every running statistic "
        f"m^n rm0 + (1 - m^n) batch within {worst_upd:.2e} of its largest "
        f"entry (one update a step; tol {VISION_STAT_TOL})")
    check(dp.captures == 1, "vision check: captures")
    check(worst_upd <= VISION_STAT_TOL, "vision check: not one running "
          "statistics update a step")
    return dict(loss_card=lg, loss_cpu=lc, loss_cpu_f64=l64,
                loss_rel_err=loss_rel, grad_worst_share_of_allowance=worst,
                grad_worst=worst_name, grad_worst_rel_err_card=worst_pair[0],
                grad_worst_rel_err_cpu_f32=worst_pair[1],
                stats_rel_err=stat_err, steps=n, update_rel_err=worst_upd)


def phase_vision_gluon(torch, dev):
    """The gluon loop (``autograd.record()`` + `Trainer`, SGD lr 0.01
    momentum 0.9) on the same net and batches as `DataParallel`, eager
    and hybridized (eager, capturing, replaying), for 3 steps: before
    each step the loops' nets take `DataParallel`'s weights and
    statistics (copied in place, so the hybridized graphs read them), and
    after it their running statistics are held against `DataParallel`'s
    (a fresh ResNet-50's gradients at batch 4 are ill-conditioned, so
    weights that drift apart by rounding would move the next step's
    statistics by more than the update's own error); predict mode leaves
    them alone."""
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, np, optimizer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.parallel.sharded import DataParallel

    base = _vision_cpu_net(mx, resnet50_v1, VISION_SIZE, 2)
    nets = {k: _vision_on(mx, base, mx.gpu(0))
            for k in ("dp", "eager", "hybridized")}
    nets["hybridized"].hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    dp = DataParallel(nets["dp"], loss_fn,
                      optimizer.SGD(learning_rate=0.01, momentum=0.9))
    trainers = {k: gluon.Trainer(nets[k].collect_params(), "sgd",
                                 {"learning_rate": 0.01, "momentum": 0.9})
                for k in ("eager", "hybridized")}
    rng = onp.random.RandomState(2)
    worst = {k: 0.0 for k in trainers}
    with mx.gpu(0):
        for _ in range(VISION_GLUON_STEPS):
            x = np.array(rng.uniform(-1, 1, (VISION_CHECK_B, 3, VISION_SIZE,
                                             VISION_SIZE)).astype("float32"))
            y = np.array(rng.randint(0, 1000, (VISION_CHECK_B,))
                         .astype("int32"))
            state = {k: p.data()._data.detach().clone()
                     for k, p in nets["dp"].collect_params().items()}
            dp.step(x, y)
            for k, tr in trainers.items():
                for name, p in nets[k].collect_params().items():
                    p.set_data(state[name])
                with autograd.record():
                    loss = loss_fn(nets[k](x), y)
                loss.backward()
                tr.step(VISION_CHECK_B)
            ref = _stats(nets["dp"])
            for k in trainers:
                got = _stats(nets[k])
                worst[k] = max(worst[k], max(_rel_max(got[s], ref[s])
                                             for s in ref))
        frozen = {k: _stats(nets[k]) for k in trainers}
        for k in trainers:
            nets[k](x)                        # predict mode
        still = all(torch.equal(frozen[k][s], v)
                    for k in trainers for s, v in _stats(nets[k]).items())
    hyb = nets["hybridized"].captures
    log(f"[vision gluon] resnet50_v1 batch {VISION_CHECK_B}, "
        f"{VISION_GLUON_STEPS} steps from DataParallel's weights: the gluon "
        f"loop's running statistics after each step within "
        f"{worst['eager']:.2e} (eager) and {worst['hybridized']:.2e} "
        f"(hybridized: {hyb} capture) of DataParallel's largest (tol "
        f"{VISION_STAT_TOL}); a predict-mode call leaves them "
        f"{'alone' if still else 'CHANGED'}")
    check(max(worst.values()) <= VISION_STAT_TOL,
          "vision gluon: running statistics")
    check(still, "vision gluon: predict mode moved the running statistics")
    check(hyb == 1, f"vision gluon: {hyb} captures, expected 1")
    return dict(steps=VISION_GLUON_STEPS,
                stats_rel_err_vs_dp=worst, hybridized_captures=hyb,
                predict_leaves_stats=still)


def phase_vision_dropout(torch, dev):
    """`alexnet()` at batch 128 x 3 x 224 x 224 through `DataParallel`
    (SGD at lr 0: the weights stay, so only the masks move the loss):
    its two ``Dropout(0.5)`` through K5, 2 launches forward and 2
    backward a step, counted at the eager and the capturing step and read
    back from a profiled replay; the masks differ across replays (the
    losses do); K5 against its plain version at the sites' shape (p = 0:
    the identity, no launch; p = 0.5 bit for bit)."""
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, np, optimizer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import alexnet
    from incubator_mxnet_tpu_torch.ops import dropout as dpo
    from incubator_mxnet_tpu_torch.parallel.sharded import DataParallel

    mx.random.seed(3)
    net = alexnet()
    net.initialize()
    rng = onp.random.RandomState(3)
    x = np.array(rng.uniform(-1, 1, (VISION_B, 3, VISION_SIZE, VISION_SIZE))
                 .astype("float32"))
    y = np.array(rng.randint(0, 1000, (VISION_B,)).astype("int32"))
    net(x[:1])
    dp = DataParallel(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                      optimizer.SGD(learning_rate=0.0, momentum=0.9))
    reset_counts()
    losses = [dp.step(x, y) for _ in range(2)]   # eager, capturing
    counted = read_counts()
    losses += [dp.step(x, y) for _ in range(3)]
    vals = [float(v.asnumpy()) for v in losses]
    seen, _ = census_launches(profiled(torch, lambda: dp.step(x, y)))
    distinct = len(set(vals[2:])) == len(vals[2:])
    log(f"[vision dropout] alexnet batch {VISION_B}, DataParallel (lr 0): K5 "
        f"launches at the eager and the capturing step {counted['K5']} "
        f"(expected {2 * ALEXNET_K5_PER_STEP}; the key fold "
        f"{counted['fold']}), in a profiled replay {seen['K5']} (expected "
        f"{ALEXNET_K5_PER_STEP}; fold {seen['fold']}); replays' losses "
        f"{[round(v, 6) for v in vals[2:]]}: "
        f"{'all different' if distinct else 'NOT all different'} (new masks "
        f"a replay)")
    check(counted["K5"] == 2 * ALEXNET_K5_PER_STEP,
          "vision dropout: K5 launches counted")
    check(seen["K5"] == ALEXNET_K5_PER_STEP and seen["fold"] == 1,
          "vision dropout: K5 and fold launches in a replay")
    # the step's keys: one fold a step, at the first dropout site
    check(counted["fold"] == 2 and all(
        v == 0 for k, v in counted.items() if k not in ("K5", "fold")),
        f"vision dropout: launched {counted}")
    check(distinct, "vision dropout: the masks did not change across replays")
    # K5 at the sites' shape against its plain version
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        h = torch.randn(VISION_B, 4096, device=dev).to(dt)
        same0 = dpo.dropout(h, (5, 6), 0.0, impl="kernel") is h
        k = dpo.dropout(h, (5, 6), 0.5, impl="kernel")
        p = dpo.dropout(h, (5, 6), 0.5, impl="plain")
        errs[str(dt).replace("torch.", "")] = float((k.float() - p.float())
                                                    .abs().max())
        check(same0 and torch.equal(k, p),
              f"vision dropout: K5 {dt} against plain")
    log(f"[vision dropout] K5 at ({VISION_B}, 4096), p = 0.5, against its "
        f"plain version: max abs err {errs} (bit for bit); p = 0 the identity")
    return dict(k5_counted=counted["K5"], k5_profiled_replay=seen["K5"],
                replay_losses=vals[2:], k5_vs_plain_max_abs_err=errs), {
                    k: v for k, v in counted.items() if v}


def phase_vision_inference(torch, dev):
    """The packaged `mobilenet0.25_digits` weights: card logits against
    CPU logits on 64 seeded 3 x 32 x 32 inputs; every family of
    ``vision._models`` (its smallest member) at batch 8, 224^2
    (Inception 299^2) in predict mode: shape, finite values, the first
    image's logits against the CPU's."""
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store, vision

    with mx.cpu():
        cpu = vision.mobilenet0_25(classes=10)
        cpu.load_parameters(model_store.get_model_file("mobilenet0.25_digits"))
    card = _vision_on(mx, cpu, mx.gpu(0))
    xn = onp.random.RandomState(4).uniform(
        0, 1, (VISION_DIGITS_N, 3, 32, 32)).astype("float32")
    with torch.no_grad():
        want = cpu(torch.from_numpy(xn))
        got = card(torch.from_numpy(xn).to(dev)).cpu()
    digits_err = _rel_max(got, want)
    log(f"[vision infer] mobilenet0.25_digits (the packaged weights), "
        f"{VISION_DIGITS_N} inputs 3 x 32^2: card logits within "
        f"{digits_err:.2e} of the CPU's largest (tol {VISION_LOGIT_TOL}); "
        f"argmax agrees on "
        f"{int((got.argmax(1) == want.argmax(1)).sum())}/{VISION_DIGITS_N}")
    check(digits_err <= VISION_LOGIT_TOL, "vision infer: digits logits")
    fam = {}
    for i, (name, size) in enumerate(VISION_FAMILIES):
        cpu = _vision_cpu_net(mx, lambda n=name: vision.get_model(n),
                              size, 10 + i)
        card = _vision_on(mx, cpu, mx.gpu(0))
        xn = onp.random.RandomState(20 + i).uniform(
            -1, 1, (VISION_FAMILY_B, 3, size, size)).astype("float32")
        with torch.no_grad():
            out = card(torch.from_numpy(xn).to(dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card(torch.from_numpy(xn).to(dev))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ref = cpu(torch.from_numpy(xn[:1]))
        err = _rel_max(out[:1].cpu(), ref)
        ok = tuple(out.shape) == (VISION_FAMILY_B, 1000) \
            and bool(torch.isfinite(out).all()) and err <= VISION_LOGIT_TOL
        fam[name] = dict(size=size, shape=list(out.shape), rel_err=err,
                         forward_ms=ms)
        log(f"[vision infer] {name} batch {VISION_FAMILY_B} x 3 x {size}^2: "
            f"{tuple(out.shape)}, finite, first image within {err:.2e} of "
            f"the CPU's largest logit; forward {ms:.2f} ms (wall)")
        check(ok, f"vision infer: {name}")
        del cpu, card, out
    return dict(digits_rel_err=digits_err, families=fam)


def phase_vision(torch, dev):
    """[vision]: bench.py's ResNet-50-v1 training (f32 and bf16 AMP), the
    step against the CPU and one statistics update a step, the gluon
    loops, AlexNet's dropout through K5, inference of the zoo. Returns
    (numbers, K5 launches of the main path)."""
    t0 = time.perf_counter()
    out = {}
    out["f32"] = phase_vision_bench(torch, dev, "f32")
    torch.cuda.empty_cache()
    out["bf16"] = phase_vision_bench(torch, dev, "bf16")
    torch.cuda.empty_cache()
    out["check"] = phase_vision_check(torch, dev)
    torch.cuda.empty_cache()
    out["gluon"] = phase_vision_gluon(torch, dev)
    torch.cuda.empty_cache()
    out["dropout"], counted = phase_vision_dropout(torch, dev)
    torch.cuda.empty_cache()
    out["inference"] = phase_vision_inference(torch, dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[vision] phase took {out['seconds']:.1f} s")
    return out, counted


# ---------------------------------------------------------------------------
# [np4]: the np/npx/nd remainder, a reference-style user script on the card
# ---------------------------------------------------------------------------

NP4_B, NP4_T, NP4_C, NP4_H = 8, 64, 768, 12   # BERT-base's width and heads
NP4_LAYERS, NP4_CLASSES, NP4_STEPS = 2, 16, 3
NP4_P, NP4_LR, NP4_CLIP, NP4_SEED = 0.1, 0.5, 1.0, 17
# the script on the card against the CPU at p = 0: losses, gradient norms,
# the metric and the final weights, max|d| / max|cpu| (f32, TF32 off:
# cuBLAS and the CPU's BLAS sum the products in other orders)
NP4_TOL = 1e-4
# every np.linalg name on the card against the CPU (its invariants: the
# decompositions by their values and reconstructions)
NP4_LINALG_TOL = 1e-4
NP4_LINALG_N = 64
NP4_SAMPLES = 10 ** 6
NP4_MOMENT_SE = 6.0            # moments within this many standard errors
NP4_HOST_CALLS = 1000
NP4_LINALG_REPS = 20
# launches of the main path a step: a layer's LayerNorm (K4 forward; K4b
# backward, two kernels a call) and its two dropouts (K5 forward and K5
# backward each)
NP4_LAUNCHES = {"K4": NP4_LAYERS, "K4b": 2 * NP4_LAYERS,
                "K5": 4 * NP4_LAYERS}


def np4_script(mx, p, seed=NP4_SEED, steps=NP4_STEPS):
    """The reference-style user script on the current device: ``set_np``,
    a seeded two-layer self-attention classifier written with npx ops
    (``interleaved_matmul_selfatt_qk``/``_valatt``, ``masked_softmax``,
    ``sequence_mask``, ``layer_norm``, ``dropout``), ``one_hot`` and
    ``pick`` for the loss, ``topk`` for the metric, ``clip_global_norm``
    on the gradients and a plain SGD update, ``steps`` times under
    ``autograd.record()``. Returns numbers and the final weights (numpy)."""
    import numpy as onp

    np, npx, ag = mx.np, mx.npx, mx.autograd
    npx.set_np()
    npx.seed(seed)
    rng = onp.random.RandomState(seed)
    c, h = NP4_C, NP4_H

    def w(*shape, scale=0.02):
        return np.array(rng.normal(0, scale, shape).astype("float32"))

    params = {"emb": w(1000, c, scale=0.5), "out": w(c, NP4_CLASSES)}
    for layer in range(NP4_LAYERS):
        params[f"qkv{layer}"] = w(c, 3 * c)
        params[f"proj{layer}"] = w(c, c)
        params[f"gamma{layer}"] = np.ones(c)
        params[f"beta{layer}"] = np.zeros(c)
    for a in params.values():
        a.attach_grad()
    tokens = np.array(rng.randint(0, 1000, (NP4_B, NP4_T)).astype("int32"))
    vl = np.array(rng.randint(NP4_T // 2, NP4_T + 1, NP4_B)
                  .astype("float32"))
    labels = np.array(rng.randint(0, NP4_CLASSES, NP4_B).astype("float32"))
    # the (B·H, T, T) key mask of the valid lengths, batch-major as the
    # interleaved scores
    mask = np.arange(NP4_T).reshape(1, 1, 1, NP4_T) < vl.reshape(-1, 1, 1, 1)
    mask = npx.reshape(np.broadcast_to(mask, (NP4_B, h, NP4_T, NP4_T)),
                       (-3, -2))
    losses, picked_losses, norms, top1, top5 = [], [], [], [], []
    for _ in range(steps):
        with ag.record():
            x = npx.embedding(tokens, params["emb"])
            x = npx.sequence_mask(np.transpose(x, (1, 0, 2)), vl,
                                  use_sequence_length=True, axis=0)
            for layer in range(NP4_LAYERS):
                qkv = np.dot(x, params[f"qkv{layer}"])
                att = npx.interleaved_matmul_selfatt_qk(qkv, heads=h)
                att = npx.dropout(npx.masked_softmax(att, mask), p=p)
                ctx = npx.interleaved_matmul_selfatt_valatt(qkv, att,
                                                            heads=h)
                out = npx.dropout(np.dot(ctx, params[f"proj{layer}"]), p=p)
                x = npx.layer_norm(x + out, params[f"gamma{layer}"],
                                   params[f"beta{layer}"])
            pooled = npx.sequence_last(x, vl, use_sequence_length=True)
            logits = np.dot(pooled, params["out"])
            logp = npx.log_softmax(logits)
            loss = -(logp * npx.one_hot(labels, NP4_CLASSES)).sum() / NP4_B
        loss.backward()
        picked_losses.append(float(-npx.pick(logp, labels).mean()))
        losses.append(float(loss))
        norms.append(npx.clip_global_norm([a.grad for a in params.values()],
                                          NP4_CLIP))
        top = npx.topk(logits, k=5)
        hit = (top == labels.reshape(-1, 1)).astype("float32")
        top1.append(float(hit[:, 0].mean()))
        top5.append(float(hit.sum(axis=-1).mean()))
        for a in params.values():
            a[:] = a - NP4_LR * a.grad
    return dict(losses=losses, picked_losses=picked_losses, grad_norms=norms,
                top1=top1, top5=top5), {n: a.asnumpy() for n, a in
                                        params.items()}


def _np4_rel(got, ref):
    import numpy as onp

    got, ref = onp.asarray(got, "float64"), onp.asarray(ref, "float64")
    return float(onp.abs(got - ref).max() / max(onp.abs(ref).max(), 1e-30))


def phase_np4_script(torch, dev, mx):
    """The script on the card against the CPU at p = 0, and at p = NP4_P
    with the same dropout keys (recorded on both sides), its K4, K4b and
    K5 launches counted exactly; the dropout contract on the card."""
    res = {}
    t0 = time.perf_counter()
    card0, w_card0 = np4_script(mx, 0.0)
    torch.cuda.synchronize()
    res["card_p0_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with mx.cpu():
        cpu0, w_cpu0 = np4_script(mx, 0.0)
    res["cpu_p0_s"] = time.perf_counter() - t0
    errs = {k: _np4_rel(card0[k], cpu0[k]) for k in ("losses",
                                                     "picked_losses",
                                                     "grad_norms")}
    errs["weights"] = max(_np4_rel(w_card0[n], w_cpu0[n]) for n in w_cpu0)
    same_metric = card0["top1"] == cpu0["top1"] and \
        card0["top5"] == cpu0["top5"]
    worst = max(errs.values())
    log(f"[np4] script ({NP4_LAYERS} self-attention layers, {NP4_B} x "
        f"{NP4_T} x {NP4_C}, {NP4_H} heads, {NP4_STEPS} SGD steps) at p = 0, "
        f"the card vs the CPU: max|d|/max|cpu| {errs} (tol {NP4_TOL:g}); "
        f"losses card {card0['losses']} cpu {cpu0['losses']}; top-1/top-5 "
        f"equal {same_metric}; one-hot loss = pick loss "
        f"{_np4_rel(card0['losses'], card0['picked_losses']):.2e}")
    check(all(math.isfinite(v) for v in card0["losses"]
              + card0["grad_norms"]), "[np4] script: non-finite loss")
    check(worst <= NP4_TOL and same_metric,
          f"[np4] script on the card disagrees with the CPU: {errs}")
    check(_np4_rel(card0["losses"], card0["picked_losses"]) <= 1e-6,
          "[np4] script: the one-hot loss is not the pick loss")
    res.update(p0_vs_cpu=errs, p0_losses=card0["losses"],
               p0_grad_norms=card0["grad_norms"])
    # p > 0: the main path, counted, its dropout keys recorded; the CPU's
    # run with the same seed draws the same keys, and its plain dropout
    # the same Philox masks, so it agrees within the same tolerance
    from incubator_mxnet_tpu_torch import random as mxrandom

    draw, keys = mxrandom.next_key, {"card": [], "cpu": []}

    def recording(where):
        def next_key():
            k = draw()
            keys[where].append(k)
            return k
        return next_key

    try:
        mxrandom.next_key = recording("card")
        reset_counts()
        t0 = time.perf_counter()
        card1, w_card1 = np4_script(mx, NP4_P)
        torch.cuda.synchronize()
        res["card_p_s"] = time.perf_counter() - t0
        counted, layouts = read_counts(), read_layout_counts()
        mxrandom.next_key = recording("cpu")
        with mx.cpu():
            cpu1, w_cpu1 = np4_script(mx, NP4_P)
    finally:
        mxrandom.next_key = draw
    errs1 = {k: _np4_rel(card1[k], cpu1[k]) for k in ("losses",
                                                      "grad_norms")}
    errs1["weights"] = max(_np4_rel(w_card1[n], w_cpu1[n]) for n in w_cpu1)
    same_keys = keys["card"] == keys["cpu"] and len(keys["card"]) == \
        2 * NP4_LAYERS * NP4_STEPS
    want = {k: n * NP4_STEPS for k, n in NP4_LAUNCHES.items()}
    log(f"[np4] script at p = {NP4_P:g} on the card: losses "
        f"{card1['losses']}, grad norms {card1['grad_norms']}; the CPU with "
        f"the same seed drew the same {len(keys['card'])} dropout keys "
        f"{same_keys}, max|d|/max|cpu| {errs1} (tol {NP4_TOL:g}); launches "
        f"{counted} (expected {want}); {res['card_p_s']:.2f} s")
    check(same_keys and max(errs1.values()) <= NP4_TOL,
          f"[np4] script at p = {NP4_P:g}: keys equal {same_keys}, "
          f"vs the CPU {errs1}")
    check(all(counted[k] == n for k, n in want.items()) and all(
        v == 0 for k, v in counted.items() if k not in want),
        f"[np4] script launches {counted}, expected {want}")
    res.update(p_losses=card1["losses"], p_vs_cpu=errs1,
               p_keys=len(keys["card"]), launches=counted)
    # the dropout contract at p = NP4_P on the card: the keep fraction,
    # the 1/(1-p) scale, the backward's mask the forward's
    x = mx.np.ones((NP4_B * NP4_T, NP4_C))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.npx.dropout(x, p=NP4_P)
    y.backward()
    yt, gt = y._data, x.grad._data
    keep = float((yt != 0).float().mean())
    n = yt.numel()
    se = math.sqrt(NP4_P * (1 - NP4_P) / n)
    scale_ok = bool(torch.all((yt == 0) | ((yt - 1 / (1 - NP4_P)).abs()
                                           <= 1e-6)))
    same_mask = bool(torch.equal(gt, yt))
    log(f"[np4] dropout contract on the card ({n} elements, p = {NP4_P:g}): "
        f"keep fraction {keep:.5f} (1 - p = {1 - NP4_P:g}, "
        f"{abs(keep - (1 - NP4_P)) / se:.2f} SE), kept values 1/(1-p) "
        f"{scale_ok}, the backward's mask the forward's {same_mask}")
    check(abs(keep - (1 - NP4_P)) <= NP4_MOMENT_SE * se and scale_ok
          and same_mask, "[np4] dropout contract")
    res["dropout_contract"] = dict(keep=keep, scale=scale_ok,
                                   same_mask=same_mask)
    return res, counted, layouts


def _np4_linalg_cases(mx, a_np, b_np, spd_np, rect_np, low_np):
    """name -> (function of (mx, arrays) -> list of invariant arrays,
    inputs)."""
    import numpy as onp

    la = mx.np.linalg

    def recon_svd(m):
        u, s, vh = la.svd(m, full_matrices=False)
        return [s, (u * s.reshape(1, -1)) @ vh]

    def recon_qr(m):
        q, r = la.qr(m)
        return [q @ r, mx.np.abs(r)]

    def recon_eigh(m):
        w, v = la.eigh(m)
        return [w, (v * w.reshape(1, -1)) @ v.T]

    def recon_eig(m):
        w, v = la.eig(m)
        return [mx.np.sort(mx.np.real(w)),
                mx.np.real(v @ (w.reshape(-1, 1) * la.inv(v)))]

    def recon_syevd(m):
        u, lam = la.syevd(m)
        return [lam, (u.T * lam.reshape(1, -1)) @ u]

    def recon_gelqf(m):
        lo, q = la.gelqf(m)
        return [lo @ q, mx.np.abs(lo)]

    A, B, S, Rm, L = a_np, b_np, spd_np, rect_np, low_np
    one = onp.ones(6, "float32")
    return {
        "norm": (lambda m: [la.norm(m), la.norm(m, 1, axis=0)], [Rm]),
        "svd": (recon_svd, [Rm]),
        "cholesky": (lambda m: [la.cholesky(m)], [S]),
        "qr": (recon_qr, [Rm]),
        "inv": (lambda m: [la.inv(m)], [A]),
        "pinv": (lambda m: [la.pinv(m)], [Rm]),
        "det": (lambda m: [la.det(m / 8)], [A]),
        "slogdet": (lambda m: list(la.slogdet(m)), [A]),
        "solve": (lambda m, b: [la.solve(m, b)], [A, B]),
        "lstsq": (lambda m, b: [r for i, r in enumerate(la.lstsq(m, b))
                                if i != 2], [Rm, onp.concatenate([B, B])
                                             [:Rm.shape[0]]]),
        "eig": (recon_eig, [A]),
        "eigh": (recon_eigh, [S]),
        "eigvals": (lambda m: [mx.np.sort(mx.np.real(la.eigvals(m)))], [S]),
        "eigvalsh": (lambda m: [la.eigvalsh(m)], [S]),
        "matrix_rank": (lambda m: [la.matrix_rank(m)], [Rm]),
        "matrix_power": (lambda m: [la.matrix_power(m / 8, 3)], [A]),
        "multi_dot": (lambda m, b: [la.multi_dot([m, m, b])], [A, B]),
        "tensorinv": (lambda m: [la.tensorinv(m, ind=1)], [A]),
        "tensorsolve": (lambda m, b: [la.tensorsolve(m, b[:, 0])], [A, B]),
        "cond": (lambda m: [la.cond(m)], [A]),
        "gemm2": (lambda m, b: [la.gemm2(m, b, alpha=0.5)], [A, B]),
        "gemm": (lambda m, b: [la.gemm(m, m, b @ b.T, transpose_b=True,
                                       beta=-1.0)], [A, B]),
        "syevd": (recon_syevd, [S]),
        "potrf": (lambda m: [la.potrf(m)], [S]),
        "potri": (lambda m: [la.potri(m)], [L]),
        "trsm": (lambda m, b: [la.trsm(m, b, alpha=2.0)], [L, B]),
        "trmm": (lambda m, b: [la.trmm(m, b, transpose=True)], [L, B]),
        "syrk": (lambda m: [la.syrk(m, alpha=0.5)], [Rm]),
        "gelqf": (recon_gelqf, [Rm.T.copy()]),
        "sumlogdiag": (lambda m: [la.sumlogdiag(m)], [S]),
        "extractdiag": (lambda m: [la.extractdiag(m, offset=1)], [A]),
        "makediag": (lambda v: [la.makediag(v, offset=-1)], [one]),
        "extracttrian": (lambda m: [la.extracttrian(m)], [A]),
        "maketrian": (lambda v: [la.maketrian(v)], [onp.ones(21,
                                                             "float32")]),
        "inverse": (lambda m: [la.inverse(m)], [A]),
    }


def phase_np4_linalg(torch, mx):
    """Every np.linalg name once on the card against the CPU, and
    solve/svd through the funnel against ``torch.linalg`` on the same
    tensors (wall time a call, synchronised)."""
    import numpy as onp

    n = NP4_LINALG_N
    rng = onp.random.RandomState(NP4_SEED)
    a = (rng.normal(size=(n, n)) + n ** 0.5 * onp.eye(n)).astype("float32")
    b = rng.normal(size=(n, 8)).astype("float32")
    spd = (a @ a.T / n + onp.eye(n)).astype("float32")
    rect = rng.normal(size=(n + 16, n // 2)).astype("float32")
    low = onp.tril(a).astype("float32")
    cases = _np4_linalg_cases(mx, a, b, spd, rect, low)
    errs = {}
    for name, (fn, arrays) in cases.items():
        card = fn(*[mx.np.array(v) for v in arrays])
        with mx.cpu():
            cpu = fn(*[mx.np.array(v) for v in arrays])
        check(all(c._data.device.type == "cuda" for c in card),
              f"[np4] linalg.{name} did not run on the card")
        errs[name] = max(_np4_rel(c.asnumpy(), r.asnumpy())
                         for c, r in zip(card, cpu))
    worst = max(errs, key=errs.get)
    log(f"[np4] np.linalg: {len(errs)} names on the card vs the CPU "
        f"(n = {n}), worst {worst} {errs[worst]:.2e} (tol "
        f"{NP4_LINALG_TOL:g}); " + ", ".join(f"{k} {v:.1e}"
                                            for k, v in errs.items()))
    check(errs[worst] <= NP4_LINALG_TOL, f"[np4] linalg.{worst} on the "
          f"card disagrees with the CPU: {errs[worst]:.2e}")
    # solve and svd: through the funnel vs torch.linalg direct
    A, B = mx.np.array(a), mx.np.array(b)
    at, bt = A._data, B._data

    def wall_us(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(NP4_LINALG_REPS):
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e6)
        return sorted(times)[len(times) // 2]

    ratios = {}
    for name, funnel, direct in (
            ("solve", lambda: mx.np.linalg.solve(A, B),
             lambda: torch.linalg.solve(at, bt)),
            ("svd", lambda: mx.np.linalg.svd(A),
             lambda: torch.linalg.svd(at))):
        f_us, d_us = wall_us(funnel), wall_us(direct)
        ratios[name] = dict(funnel_us=f_us, torch_us=d_us,
                            ratio=f_us / d_us)
    log(f"[np4] np.linalg through the funnel / torch.linalg direct, "
        f"({n}, {n}) f32, median wall us a call (synchronised): "
        + "; ".join(f"{k} {v['funnel_us']:.1f} / {v['torch_us']:.1f} = "
                    f"{v['ratio']:.3f}" for k, v in ratios.items()))
    return dict(vs_cpu=errs, funnel_vs_torch=ratios)


def _np4_moments():
    """name -> (args, exact mean, exact variance) of each scalar
    distribution at the parameters ``[np4]`` draws it with."""
    g = math.gamma
    k = 1.5
    w1, w2 = g(1 + 1 / k), g(1 + 2 / k)
    ln_m, ln_s = 0.5, 0.25
    return {
        "beta": ((2.0, 3.0), 0.4, 0.04),
        "gamma": ((2.0, 1.5), 3.0, 4.5),
        "exponential": ((2.0,), 2.0, 4.0),
        "chisquare": ((3.0,), 3.0, 6.0),
        "laplace": ((1.0, 2.0), 1.0, 8.0),
        "logistic": ((1.0, 2.0), 1.0, math.pi ** 2 / 3 * 4),
        "lognormal": ((ln_m, ln_s), math.exp(ln_m + ln_s ** 2 / 2),
                      (math.exp(ln_s ** 2) - 1)
                      * math.exp(2 * ln_m + ln_s ** 2)),
        "pareto": ((5.0,), 0.25, 5 / (16 * 3)),
        "power": ((2.5,), 2.5 / 3.5, 2.5 / (3.5 ** 2 * 4.5)),
        "rayleigh": ((2.0,), 2 * math.sqrt(math.pi / 2),
                     (4 - math.pi) / 2 * 4),
        "weibull": ((k,), w1, w2 - w1 * w1),
        "gumbel": ((1.0, 2.0), 1 + 2 * 0.5772156649015329,
                   math.pi ** 2 / 6 * 4),
        "binomial": ((10, 0.3), 3.0, 2.1),
        "poisson": ((3.5,), 3.5, 3.5),
        "geometric": ((0.3,), 1 / 0.3, 0.7 / 0.09),
        "negative_binomial": ((3, 0.4), 4.5, 11.25),
        "f": ((5.0, 20.0), 20 / 18,
              2 * 400 * 23 / (5 * 18 ** 2 * 16)),
    }


def phase_np4_random(torch, mx):
    """NP4_SAMPLES draws of each of the 20 distributions on the card: the
    sample mean and variance against the exact ones within NP4_MOMENT_SE
    standard errors (the variance's from the sample's fourth moment); the
    vector ones (multinomial, multivariate_normal, dirichlet) by each
    component's mean and variance."""
    n = NP4_SAMPLES
    mx.random.seed(NP4_SEED)
    worst, rows = 0.0, {}

    def moments(x, mean, var, name):
        nonlocal worst
        x = x.double()
        m, v = float(x.mean()), float(x.var(correction=0))
        m4 = float(((x - m) ** 4).mean())
        z_mean = abs(m - mean) / math.sqrt(var / n)
        z_var = abs(v - var) / math.sqrt(max(m4 - v * v, 1e-300) / n)
        worst = max(worst, z_mean, z_var)
        rows[name] = dict(mean=m, exact_mean=mean, var=v, exact_var=var,
                          z_mean=z_mean, z_var=z_var)

    t0 = time.perf_counter()
    for name, (args, mean, var) in _np4_moments().items():
        x = getattr(mx.np.random, name)(*args, size=n)._data
        check(x.device.type == "cuda" and x.numel() == n,
              f"[np4] np.random.{name}: not {n} draws on the card")
        moments(x, mean, var, name)
    pv = [0.2, 0.3, 0.5]
    c = mx.np.random.multinomial(10, pv, size=n)._data
    check(bool((c.sum(-1) == 10).all()), "[np4] multinomial counts")
    for i, p in enumerate(pv):
        moments(c[:, i], 10 * p, 10 * p * (1 - p), f"multinomial[{i}]")
    cov = [[2.0, 0.6], [0.6, 1.0]]
    z = mx.np.random.multivariate_normal(mx.np.array([1.0, -2.0]),
                                         mx.np.array(cov), size=n)._data
    for i, mu in enumerate((1.0, -2.0)):
        moments(z[:, i], mu, cov[i][i], f"multivariate_normal[{i}]")
    moments(z[:, 0] + z[:, 1], -1.0, 2.0 + 1.0 + 1.2,
            "multivariate_normal[0+1]")
    alpha = [1.0, 2.0, 3.0]
    d = mx.np.random.dirichlet(mx.np.array(alpha), size=n)._data
    a0 = sum(alpha)
    for i, a in enumerate(alpha):
        moments(d[:, i], a / a0, a * (a0 - a) / (a0 ** 2 * (a0 + 1)),
                f"dirichlet[{i}]")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[np4] np.random: {n} draws of each of the 20 distributions on the "
        f"card, {len(rows)} moments checked, the worst "
        f"{worst:.2f} standard errors off (limit {NP4_MOMENT_SE:g}); "
        f"{secs:.2f} s; " + ", ".join(
            f"{k} z {v['z_mean']:.2f}/{v['z_var']:.2f}"
            for k, v in rows.items()))
    check(worst <= NP4_MOMENT_SE, "[np4] a distribution's moments are off")
    return dict(worst_z=worst, seconds=secs, moments=rows)


def phase_np4_legacy_io(torch, dev, mx):
    """A gluon block's weights through the reference's binary ``.params``
    container on the card: saved with MXNet's ``arg:`` prefixes, loaded by
    ``load_parameters`` into a second block, bit for bit, the same
    outputs."""
    import os
    import tempfile

    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(64, in_units=NP4_C, activation="relu"),
            mx.gluon.nn.Dense(NP4_CLASSES, in_units=64))
    mx.random.seed(NP4_SEED)
    net.initialize(device=mx.gpu(0))
    twin = mx.gluon.nn.HybridSequential()
    twin.add(mx.gluon.nn.Dense(64, in_units=NP4_C, activation="relu"),
             mx.gluon.nn.Dense(NP4_CLASSES, in_units=64))
    twin.initialize(device=mx.gpu(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "net.params")
        mx.nd.save(path, {f"arg:{k}": p.data() for k, p in
                          net.collect_params().items()}, format="legacy")
        size = os.path.getsize(path)
        twin.load_parameters(path)
        back = mx.nd.load(path)
    same = all(torch.equal(p.data()._data, q.data()._data) for p, q in zip(
        net.collect_params().values(), twin.collect_params().values()))
    x = mx.np.random.normal(size=(NP4_B, NP4_C))
    out_same = torch.equal(net(x)._data, twin(x)._data)
    on_card = all(v._data.device == dev for v in back.values())
    log(f"[np4] legacy .params on the card: {len(back)} arrays, {size} "
        f"bytes; load_parameters bit for bit {same}, outputs equal "
        f"{out_same}, nd.load onto cuda:0 {on_card}")
    check(same and out_same and on_card, "[np4] legacy .params round trip")
    return dict(arrays=len(back), bytes=size, bitwise=same)


def phase_np4_host(torch, mx):
    """The funnel's host us a call for topk, pick, one_hot and reshape
    with codes on (64, 128) f32 NDArrays on the card, beside the torch
    call closest to each on the same tensors."""
    import torch.nn.functional as F

    x = mx.np.random.uniform(size=(64, 128))
    idx = mx.np.array(list(range(64)), dtype="int32")
    xt, it = x._data, idx._data.long()

    def per_call_us(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(NP4_HOST_CALLS):
            fn()
        us = (time.perf_counter() - start) / NP4_HOST_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    ops = {
        "topk": (lambda: mx.npx.topk(x, k=5),
                 lambda: torch.topk(xt, 5)),
        "pick": (lambda: mx.npx.pick(x, idx),
                 lambda: xt.gather(1, it[:, None])),
        "one_hot": (lambda: mx.npx.one_hot(idx, 128),
                    lambda: F.one_hot(it, 128)),
        "reshape_codes": (lambda: mx.npx.reshape(x, (-4, 8, -1, -2)),
                          lambda: xt.reshape(8, 8, 128)),
    }
    res = {}
    for name, (nd_fn, t_fn) in ops.items():
        res[name] = dict(npx_us=per_call_us(nd_fn), torch_us=per_call_us(t_fn))
    log("[np4] host us a call, (64, 128) f32 on the card, npx (the funnel) "
        "vs the closest torch call: " + "; ".join(
            f"{k} {v['npx_us']:.2f} vs {v['torch_us']:.2f}"
            for k, v in res.items()))
    return res


def phase_np4(torch, dev):
    """[np4]: the np/npx/nd remainder on the card: the reference-style
    ``npx.set_np()`` script against the CPU (p = 0) and at p = NP4_P (K4,
    K4b, K5 counted), every np.linalg name against the CPU, 10^6 draws of
    each distribution against its moments, a legacy ``.params`` round
    trip, the funnel's host time. Returns (numbers, launches, launches by
    layout)."""
    import incubator_mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    res = {}
    res["script"], launches, layouts = phase_np4_script(torch, dev, mx)
    res["linalg"] = phase_np4_linalg(torch, mx)
    res["random"] = phase_np4_random(torch, mx)
    res["legacy_io"] = phase_np4_legacy_io(torch, dev, mx)
    res["host"] = phase_np4_host(torch, mx)
    mx.waitall()
    res["seconds"] = time.perf_counter() - t0
    log(f"[np4] phase took {res['seconds']:.1f} s; launches {launches}")
    return res, launches, layouts


# ---------------------------------------------------------------------------
# [observe]: the profiler, the kernel census and roofline, the funnel's
# stages, the monitor and the auditor on the card, through the package's
# own API
# ---------------------------------------------------------------------------

OBS_STEPS = 3        # bench.py:400's profiled DataParallel steps
OBS_TIMED = 10       # unprofiled replays timed for the wall MFU
OBS_MFU_RATIO = 0.95  # trace MFU at least this share of the wall MFU
OBS_BATCHES, OBS_BATCH = 40, 50   # the host-time batches of [observe stages]
# [np4]'s host us a call of each npx call and of the closest torch call
# before the funnel had its seams, two runs (PERF.md §6): (npx, torch)
OBS_NP4_BEFORE = {"topk": ((82.46, 15.32), (93.01, 33.10)),
                "pick": ((94.26, 10.87), (149.04, 22.31)),
                "one_hot": ((64.67, 18.54), (76.63, 19.06)),
                "reshape_codes": ((11.12, 2.62), (10.57, 1.59))}
OBS_NP4_CALLS, OBS_NP4_LOOPS = 200, 5  # [np4]'s loop, the least of 5
OBS_COPY_BYTES = 1 << 30   # the device-to-device copy of the peaks
OBS_GEMM_N = 8192          # the bf16 product of the peaks (n x n x n)
# the census rows of the port's kernels by class (a row backward counts
# its row kernel and its reduction, as the counters do)
_OBS_TAGS = {"flash_fwd_kernel": "K1", "flash_bwd_delta_kernel": "K2",
             "flash_bwd_dq_kernel": "K2", "flash_bwd_dkv_kernel": "K2",
             "dropout_kernel": "K5", "fold_keys_kernel": "fold",
             "ln_partials_reduce_kernel": "reduce"}


def _obs_class(name):
    """(K class, launch-log tag) of a census row's kernel name, or None
    for a kernel that is not the port's."""
    import re

    from incubator_mxnet_tpu_torch import profiler

    m = profiler.PORT_KERNEL.search(name)
    if m is None:
        return None
    tag = m.group(1)
    row = re.search(r"ln_(fwd|bwd)_kernel<([^>]*)>", name)
    gd = re.search(r"gelu_dropout_kernel<([^>]*)>", name)
    if row:
        mode = int(row.group(2).split(",")[-1])
        if row.group(1) == "fwd":
            return ("K4" if mode == 0 else "K3f"), tag
        return ("K4b" if mode == 0 else "K3b"), tag
    if gd:
        bwd = gd.group(1).split(",")[-1].strip() == "true"
        return ("K6b" if bwd else "K6f"), tag
    return _OBS_TAGS[tag], tag


def _obs_dtype(torch, name):
    """The first template argument of a kernel's name as a torch dtype."""
    import re

    m = re.search(r"<\s*([A-Za-z_0-9:]+)", name)
    arg = m.group(1) if m else ""
    return {"float": torch.float32, "__nv_bfloat16": torch.bfloat16,
            "__half": torch.float16}.get(arg.split("::")[-1])


def _obs_classes(rows):
    """{class: [count, bytes, flops, bytes-known, flops-known]} and {log
    tag: count} of a census's port-kernel rows."""
    by_class, by_tag = {}, {}
    for r in rows:
        got = _obs_class(r["name"])
        if got is None:
            continue
        cls, tag = got
        acc = by_class.setdefault(cls, [0, 0, 0, 0, 0])
        for i, k in enumerate(("count", "bytes", "flops", "bytes_known",
                               "flops_known")):
            acc[i] += r[k]
        by_tag[tag] = by_tag.get(tag, 0) + r["count"]
    return by_class, by_tag


def _obs_bert_costs(torch):
    """{class: (bytes, flops)} a step of the BERT-base AMP DataParallel
    step launches, from the wrappers' cost functions at its shapes
    (PERF.md §6): K1/K2 bf16 (64, 12, 128, 64); the embedding LayerNorm
    f32 and the MLM one bf16 x with f32 gamma; 24 residual sites f32 x,
    bf16 h, f32 gamma; one fold. K5's sites are held row by row."""
    from incubator_mxnet_tpu_torch.ops import dropout as dp
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")

    f32, bf16 = torch.float32, torch.bfloat16
    heads = 12

    def add(*costs):
        return (sum(c[0] for c in costs), sum(c[1] for c in costs))

    def times(n, cost):
        return n * cost[0], n * cost[1]

    att = (TRAIN_B, heads, TRAIN_T, TRAIN_T, C // heads, bf16)
    k2 = add(*[fa.bwd_cost(*att, kernel=k) for k in fa.BWD_KERNELS])
    return {
        "K1": times(12, fa.cost(*att)),
        "K2": times(12, k2),
        "K4": add(ln.cost(ROWS, C, f32, f32), ln.cost(ROWS, C, bf16, f32)),
        "K4b": add(ln.bwd_cost(ROWS, C, f32, f32, kernel="rows"),
                   ln.bwd_cost(ROWS, C, bf16, f32, kernel="rows")),
        "K3f": times(24, fb.cost(ROWS, C, f32, bf16, f32)),
        "K3b": times(24, fb.bwd_cost(ROWS, C, f32, bf16, f32,
                                     kernel="rows")),
        "reduce": add(ln.bwd_cost(ROWS, C, f32, f32, kernel="reduce"),
                      ln.bwd_cost(ROWS, C, bf16, f32, kernel="reduce"),
                      times(24, fb.bwd_cost(ROWS, C, f32, bf16, f32,
                                            kernel="reduce"))),
        "fold": dp.fold_cost(),
    }


def _obs_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_observe_train(torch, dev, card, smi):
    """bench.py:400's cross-check on the port: profiler.start(), three
    DataParallel steps of BERT-base at 64 x 128 under bf16 AMP,
    profiler.stop(), kernels.census and program_mfu; the census held to
    the captured graph's launch log and the wrappers' costs; the roofline
    phases; the wall MFU of the same step unprofiled. The cycle as
    bench.py runs it comes first and is reported; the held cycle replays
    once inside profiler.pause() before its three steps."""
    from incubator_mxnet_tpu_torch import amp, profiler
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel
    from incubator_mxnet_tpu_torch.telemetry import compiles, kernels, roofline

    ce = SoftmaxCrossEntropyLoss()

    def mlm_loss(out, y):
        return ce(out[0], y)

    net = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev, seed=0)
    dp = DataParallel(net, mlm_loss, Adam(learning_rate=TRAIN_LR))
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    n_params = sum(p.numel() for p in net.parameters())
    flops_token = 6.0 * n_params + 12.0 * 12 * TRAIN_T * C
    was_on = compiles.is_enabled()
    compiles.enable()
    amp.init("bfloat16")
    try:
        mxrandom.seed(0)
        for _ in range(WARMUP):        # eager, then capture and replay
            dp.step(tokens, labels)
        torch.cuda.synchronize()
        walls = []
        for _ in range(OBS_TIMED):
            t0 = time.perf_counter()
            dp.step(tokens, labels)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        # bench.py:400's cycle as it is written: what the trace kept is
        # reported (PERF.md §7: a graph's first replay in a profiling
        # session after the first loses its first records)
        profiler.start()
        try:
            for _ in range(OBS_STEPS):
                loss = dp.step(tokens, labels)
            loss.item()
        finally:
            profiler.stop()
        first = profiler.trace_meta()
        first_lost = kernels.census(device=card)["meta"].get(
            "lost_launches")
        log(f"[observe] {OBS_STEPS} replays as the session's first: the "
            f"census says {first_lost} launches lost; {first}")
        # the held cycle: the graph's first replay of the session inside
        # a pause (its events and launches dropped), then the three steps
        profiler.start()
        try:
            profiler.pause()
            dp.step(tokens, labels).item()
            profiler.resume()
            for _ in range(OBS_STEPS):
                loss = dp.step(tokens, labels)
            loss_v = loss.item()
        finally:
            profiler.stop()
    finally:
        amp.deinit()
        if not was_on:
            compiles.disable()
    check(math.isfinite(loss_v), "[observe] non-finite loss")
    check(dp.captures == 1, f"[observe] {dp.captures} captures, expected 1")
    graph_log = next(iter(dp._captures.values())).graph.launch_log
    ledger = compiles.ledger_report()
    fam = ledger.get("train.DataParallel.step", {})
    events = profiler.device_events()
    meta = profiler.trace_meta()
    cen = kernels.census(events, device=card, ledger=ledger)
    check(cen["meta"].get("lost_launches") == 0, f"[observe] the held "
          f"cycle's census lost {cen['meta'].get('lost_launches')} launches "
          f"({meta})")
    by_class, by_tag = _obs_classes(cen["rows"])
    log_tags = {}
    for tag, _b, _f in graph_log:
        log_tags[tag] = log_tags.get(tag, 0) + OBS_STEPS
    log(f"[observe] trace: {meta}; the captured step's launch log "
        f"{len(graph_log)} entries a replay, by kernel {log_tags} over "
        f"{OBS_STEPS} replays; the census's port kernels by kernel "
        f"{by_tag}")
    check(by_tag == log_tags, f"[observe] the census's port-kernel counts "
          f"{by_tag} differ from the launch log's {log_tags}")
    want = {k: v * OBS_STEPS for k, v in DP_STEP_LAUNCHES.items() if v}
    got = {k: v[0] for k, v in by_class.items() if k != "reduce"}
    got["K4b"] = 2 * got.get("K4b", 0)       # row kernel + its reduction
    got["K3b"] = 2 * got.get("K3b", 0)
    check(got == want and by_class.get("reduce", [0])[0]
          == (got["K4b"] + got["K3b"]) // 2,
          f"[observe] census launches by class {got} (reductions "
          f"{by_class.get('reduce', [0])[0]}), expected {want}")
    costs = _obs_bert_costs(torch)
    for cls, (nb, nf) in costs.items():
        acc = by_class.get(cls, [0, 0, 0, 0, 0])
        check(acc[1] == OBS_STEPS * nb and acc[2] == OBS_STEPS * nf,
              f"[observe] {cls}: census bytes {acc[1]}, flops {acc[2]}; "
              f"cost() x count {OBS_STEPS * nb}, {OBS_STEPS * nf}")
    from incubator_mxnet_tpu_torch.ops import dropout as dpmod

    for r in cen["rows"]:
        got_c = _obs_class(r["name"])
        if got_c is None:
            continue
        check(r["bytes_known"] == r["count"] == r["flops_known"],
              f"[observe] {r['name'][:80]}: {r['bytes_known']} of "
              f"{r['count']} launches with bytes, {r['flops_known']} with "
              f"flops")
        if got_c[0] == "K5":
            # one instantiation serves the (8192, 768) and (8192, 3072)
            # sites: the row is n of one and count - n of the other
            dt = _obs_dtype(torch, r["name"])
            small, big = (dpmod.cost(ROWS * w, dt) for w in (C, FFN))
            n_big, rem = divmod(r["bytes"] - r["count"] * small[0],
                                big[0] - small[0])
            check(rem == 0 and 0 <= n_big <= r["count"]
                  and r["flops"] == (r["count"] - n_big) * small[1]
                  + n_big * big[1],
                  f"[observe] K5 row {r['name'][:60]}: {r['bytes']} bytes, "
                  f"{r['flops']} flops over {r['count']} launches are no "
                  f"sum of its sites' cost() {small}, {big}")
            log(f"[observe]   K5 {dt}: {r['count'] - n_big} launches at "
                f"({ROWS}, {C}), {n_big} at ({ROWS}, {FFN})")
    k_rows = [r for r in cen["rows"] if _obs_class(r["name"])]
    cover = (sum(r["bytes_known"] for r in k_rows)
             / max(1, sum(r["count"] for r in k_rows)))
    check(cover == 1.0, f"[observe] bytes coverage over the K rows {cover}")
    med = sorted(walls)[OBS_TIMED // 2 - 1] / 2 + \
        sorted(walls)[OBS_TIMED // 2] / 2
    wall_mfu = flops_token * TRAIN_B * TRAIN_T / (med / 1e3) \
        / PEAK_FLOPS["bfloat16"]
    dev_s = cen["meta"]["named_us"] * 1e-6
    trace_mfu = kernels.program_mfu(flops_token * TRAIN_B * TRAIN_T,
                                    OBS_STEPS, dev_s,
                                    peak_tflops=PEAK_FLOPS["bfloat16"] / 1e12)
    ratio = trace_mfu / wall_mfu
    log(f"[observe] {smi}: BERT-base {TRAIN_B} x {TRAIN_T} bf16 AMP "
        f"DataParallel, {n_params} parameters: wall MFU {wall_mfu:.4f} "
        f"(median of {OBS_TIMED} unprofiled replays {med:.3f} ms), trace "
        f"MFU {trace_mfu:.4f} ({OBS_STEPS} profiled replays, "
        f"{cen['meta']['named_us'] / OBS_STEPS / 1e3:.3f} ms of kernels, "
        f"copies and sets a step), ratio {ratio:.4f} (at least "
        f"{OBS_MFU_RATIO})")
    check(ratio >= OBS_MFU_RATIO, f"[observe] trace MFU {trace_mfu:.4f} is "
          f"{ratio:.4f} of the wall MFU {wall_mfu:.4f}")
    log("[observe] census, top 24:\n" + kernels.format_census(cen, top=24))
    for cls in sorted(by_class):
        cnt, nb, nf = by_class[cls][:3]
        log(f"[observe]   {cls}: {cnt} launches, {nb} bytes, {nf} flops")
    roof = roofline.analyze(events, device=card)
    log("[observe] roofline phases:\n" + roofline.format_table(roof))
    total_us = cen["meta"]["total_device_us"]
    check(abs(roof["total"]["time_us"] - total_us) <= 1e-6 * total_us,
          f"[observe] roofline phases sum to {roof['total']['time_us']} us, "
          f"the census's device total is {total_us} us")
    log(f"[observe] the program ledger's DataParallel step: flops "
        f"{fam.get('flops')}, bytes_accessed (the port's kernels) "
        f"{fam.get('bytes_accessed')}; census programs "
        f"{cen['programs'].get('train.DataParallel.step')}")
    check(fam.get("flops") and fam.get("bytes_accessed") == sum(
        b for _t, b, _f in graph_log),
        f"[observe] ledger entry {fam} lacks the capture's costs")
    out = dict(steps=OBS_STEPS, wall_median_ms=med, wall_mfu=wall_mfu,
               trace_mfu=trace_mfu, mfu_ratio=ratio,
               named_us=cen["meta"]["named_us"],
               total_device_us=total_us,
               attributed_frac=cen["meta"]["attributed_frac"],
               launches_by_class={k: v[0] for k, v in by_class.items()},
               bytes_by_class={k: v[1] for k, v in by_class.items()},
               flops_by_class={k: v[2] for k, v in by_class.items()},
               phases={r["phase"]: r["time_us"] for r in roof["rows"]},
               ledger_flops=fam.get("flops"),
               ledger_bytes=fam.get("bytes_accessed"),
               trace_meta=meta, first_replays_meta=first,
               first_replays_lost_launches=first_lost,
               top=[dict(name=r["name"][:120], count=r["count"],
                         us=r["time_us"], gbs=r["achieved_gbs"],
                         bound_by=r["bound_by"]) for r in cen["rows"][:16]])
    del dp, net
    return out


def _obs_engine(torch, dev):
    """gpt2_small's ServeEngine, warmed as [serve engine] warms it, with
    every slot decoding."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small

    model = gpt2_small(device=dev, seed=0).eval()
    engine = serve.ServeEngine(model, max_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN)
    trace = _serve_trace_a(onp)
    _serve_warmup(engine, trace[0])
    return engine, trace


def _obs_profiled_step(torch, engine):
    """One engine step (a decode replay, every slot decoding) between
    profiler.start() and stop(), held (`profiled`: a step inside a pause
    first): (census, its K4 launches, trace meta)."""
    from incubator_mxnet_tpu_torch import profiler

    cen = profiled(torch, engine.step)
    by_class, _ = _obs_classes(cen["rows"])
    return cen, by_class.get("K4", [0])[0], profiler.trace_meta()


def phase_observe_serve(torch, dev):
    """Trace A through ServeEngine on gpt2_small with span tracing on, then
    one profiled decode replay after a warm-up cycle: 25 K4 launches in
    the census, and every device slice of the step inside its host span
    in chrome_trace(include_device=True)."""
    from incubator_mxnet_tpu_torch.telemetry import tracing

    engine, trace = _obs_engine(torch, dev)
    tracing.enable()
    try:
        _serve_trace(engine, trace)
        _fill_slots(engine, trace[0], 32)
        _obs_profiled_step(torch, engine)            # the warm-up cycle
        cen, k4, meta = _obs_profiled_step(torch, engine)
        payload = tracing.chrome_trace(include_device=True)
    finally:
        tracing.disable()
    check(k4 == 25, f"[observe serve] the census has {k4} K4 launches in "
          f"the profiled decode replay, expected 25 ({meta})")
    from incubator_mxnet_tpu_torch import profiler

    spans = [e for e in payload["traceEvents"]
             if e.get("ph") == "X" and e.get("name") == "serve.decode_step"]
    devs = [e for e in payload["traceEvents"]
            if e.get("ph") == "X" and e.get("pid", 0) >= 1000]
    # the replay's slices: the kernels that share the graph launch's
    # correlation id with its K4 launches
    corr = {e["args"].get("correlation") for e in devs
            if "ln_fwd_kernel" in e["name"]
            and profiler.PORT_KERNEL.search(e["name"])}
    replay = [e for e in devs if e["args"].get("correlation") in corr]
    check(spans and len(corr) == 1 and replay, f"[observe serve] "
          f"{len(spans)} decode spans, {len(devs)} device slices, launch "
          f"correlations of the K4 slices {corr}")
    span = max(spans, key=lambda e: e["ts"])
    lo, hi = span["ts"], span["ts"] + span["dur"]
    first = min(e["ts"] for e in replay)
    last = max(e["ts"] + e["dur"] for e in replay)
    others = sorted((e for e in devs if e not in replay),
                    key=lambda e: e["ts"])
    log(f"[observe serve] the profiled step's decode span [{lo:.1f}, "
        f"{hi:.1f}] us (epoch), its replay's {len(replay)} kernel slices "
        f"[{first:.1f}, {last:.1f}]: {first - lo:.1f} us after the span "
        f"opens, {hi - last:.1f} us before it closes; {len(others)} other "
        f"device slices (copies, sets, eager kernels) "
        + ", ".join(f"{e['name'][:40]} at {e['ts'] - lo:.1f}"
                    for e in others[:12])
        + f"; census K4 {k4}, trace {meta}")
    check(lo <= first and last <= hi, "[observe serve] the replay's kernel "
          f"slices do not lie inside the step's host span: they start "
          f"{first - lo:.1f} us after it opens and end {hi - last:.1f} us "
          f"before it closes (trace {meta})")
    del engine
    return dict(k4=k4, span_us=[lo, hi], device_us=[first, last],
                lead_us=first - lo, tail_us=hi - last, slices=len(replay),
                device_ms=cen["meta"]["total_device_us"] / 1e3,
                trace_meta=meta)


def phase_observe_first_cycle(torch, dev):
    """PERF.md §7's first-cycle question, after [elastic]: a profiled
    decode replay with no warm-up cycle, and one preceded by a replay
    inside a pause (`profiled`, held); the device events each kept, its
    K4 launches in the census against the 25 the launch log holds, and
    the launches the census says the trace lost. A report, not a check."""
    from incubator_mxnet_tpu_torch import profiler

    engine, trace = _obs_engine(torch, dev)
    _fill_slots(engine, trace[0], 32)
    res = {}
    for name, held in (("no warm-up", False),
                       ("a paused replay first", True)):
        cen = profiled(torch, engine.step, held=held)
        by_class, _ = _obs_classes(cen["rows"])
        meta = profiler.trace_meta()
        res[name] = dict(k4=by_class.get("K4", [0])[0],
                         lost_launches=cen["meta"].get("lost_launches"),
                         trace_meta=meta)
        log(f"[observe first cycle] after [elastic], one profiled decode "
            f"replay, {name}: {meta['events']} device events kept, census "
            f"K4 {res[name]['k4']} of 25, lost launches "
            f"{res[name]['lost_launches']}; trace {meta}")
    del engine
    return res


def phase_observe_stages(torch, mx):
    """[np4]'s funnel timings with stages.enable(): each stage's us a
    call; the stages sum to no more than the call's host us (batches of
    OBS_BATCH calls timed before their synchronisation, so no launch waits
    on a full queue: the least batch and the mean). With no hook, the
    funnel's host us a call beside the closest torch call's, by [np4]'s
    own unsynchronised loop (phase_np4_host), the least of OBS_NP4_LOOPS:
    within the spread of those figures before the seams (OBS_NP4_BEFORE),
    in us or as a ratio to the torch call (the card's host speed differs
    from run to run by more than those two runs did; the ratio takes it
    out, except where the torch call's few us are all noise)."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.telemetry import stages

    x = mx.np.random.uniform(size=(64, 128))
    idx = mx.np.array(list(range(64)), dtype="int32")
    xt, it = x._data, idx._data.long()

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        batches = []
        for _ in range(OBS_BATCHES):
            t0 = time.perf_counter()
            for _ in range(OBS_BATCH):
                fn()
            batches.append((time.perf_counter() - t0) / OBS_BATCH * 1e6)
            torch.cuda.synchronize()
        return min(batches), sum(batches) / len(batches)

    def loop_us(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(OBS_NP4_LOOPS):
            t0 = time.perf_counter()
            for _ in range(OBS_NP4_CALLS):
                fn()
            loops.append((time.perf_counter() - t0) / OBS_NP4_CALLS * 1e6)
            torch.cuda.synchronize()
        return min(loops)

    ops = {"topk": (lambda: mx.npx.topk(x, k=5),
                    lambda: torch.topk(xt, 5)),
           "pick": (lambda: mx.npx.pick(x, idx),
                    lambda: xt.gather(1, it[:, None])),
           "one_hot": (lambda: mx.npx.one_hot(idx, 128),
                       lambda: F.one_hot(it, 128)),
           "reshape_codes": (lambda: mx.npx.reshape(x, (-4, 8, -1, -2)),
                             lambda: xt.reshape(8, 8, 128))}
    res = {}
    for name, (fn, t_fn) in ops.items():
        npx_us, torch_us = loop_us(fn), loop_us(t_fn)
        off_us, off_mean = host_us(fn)
        fn()
        torch.cuda.synchronize()
        stages.reset()
        stages.enable()
        try:
            on_us, on_mean = host_us(fn)
        finally:
            stages.disable()
        rep = stages.stage_report()
        calls = OBS_BATCHES * OBS_BATCH + 1
        per = {k: v["total_us"] / calls for k, v in rep.items()}
        funnel = rep.get("prologue", {}).get("count", 0) / calls
        ratios = [a / b for a, b in OBS_NP4_BEFORE[name]]
        figs = [a for a, _b in OBS_NP4_BEFORE[name]]
        ratio = npx_us / torch_us
        res[name] = dict(npx_us=npx_us, torch_us=torch_us, ratio=ratio,
                         pr17_us=figs, pr17_ratios=ratios, off_us=off_us,
                         off_mean_us=off_mean, on_us=on_us,
                         on_mean_us=on_mean, stage_us=per,
                         funnel_calls=funnel)
        log(f"[observe stages] {name}: no hook {npx_us:.2f} us a call "
            f"(before: {figs[0]}, {figs[1]}), the closest torch call "
            f"{torch_us:.2f} ([np4]'s loop, least of {OBS_NP4_LOOPS}): ratio "
            f"{ratio:.3f} (before: " + ", ".join(f"{r:.3f}" for r in ratios)
            + f"); batched {off_us:.2f} (least; mean {off_mean:.2f}) with "
            f"no hook, {on_us:.2f} (mean {on_mean:.2f}) with the stage "
            f"probes; {funnel:g} funnel call(s) a call; stage us a call "
            + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
        check(per["total"] <= on_mean, f"[observe stages] {name}: the "
              f"stages sum to {per['total']:.2f} us a call, more than the "
              f"call's {on_mean:.2f} us")
        check(npx_us <= max(figs) + abs(figs[0] - figs[1])
              or ratio <= max(ratios) + abs(ratios[0] - ratios[1]),
              f"[observe stages] {name}: the funnel took {npx_us:.2f} us, "
              f"{ratio:.3f} x the closest torch call, with no hook: past "
              f"the spread before the seams ({figs}, ratios {ratios})")
    stages.reset()
    return res


def phase_observe_monitor(torch, dev, mx):
    """install_nan_hook("raise") on an eager gluon step with one injected
    NaN raises naming the op (the op the CPU names too); the hook during a
    hybridize capture: the capture succeeds, the launches are those of
    the capture without it, a clean replay passes check() and a NaN
    replay fails it naming an op."""
    from incubator_mxnet_tpu_torch import autograd, gluon
    from incubator_mxnet_tpu_torch.telemetry import monitor

    import numpy as onp

    def eager_nan(device):
        with mx.cpu() if device == "cpu" else mx.gpu(0):
            net = gluon.nn.HybridSequential()
            net.add(gluon.nn.Dense(16, in_units=8),
                    gluon.nn.LayerNorm(in_channels=16))
            net.initialize()
            xn = onp.ones((4, 8), "float32")
            xn[1, 3] = float("nan")
            x = mx.np.array(xn)
            monitor.install_nan_hook("raise")
            try:
                with autograd.record():
                    out = net(x)
                    (out * out).sum().backward()
            except mx.MXNetError as e:
                return str(e)
            finally:
                monitor.uninstall_nan_hook()
                monitor.clear_nan_findings()
        return None

    card_msg, cpu_msg = eager_nan("gpu"), eager_nan("cpu")
    log(f"[observe monitor] eager step with a NaN, raise mode: card "
        f"{card_msg!r}; CPU {cpu_msg!r}")
    check(card_msg is not None and card_msg == cpu_msg
          and "at op '" in card_msg,
          "[observe monitor] the NaN hook did not raise at the same op on "
          "the card as on the CPU")

    def hybrid(hook):
        mx.random.seed(3)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(C, in_units=C), gluon.nn.LayerNorm(
            in_channels=C), gluon.nn.Dropout(0.1))
        net.initialize(device=dev)
        net.hybridize()
        x = mx.np.random.uniform(size=(64, C), device=dev)
        if hook:
            monitor.install_nan_hook("warn")
        try:
            reset_counts()
            with autograd.train_mode():
                for _ in range(3):              # eager, capture, replay
                    net(x)
            torch.cuda.synchronize()
            counts = read_counts()
            caps = net._cached_graph.captures
            found = None
            if hook:
                monitor.check()                 # a clean replay passes
                bad = x.asnumpy()
                bad[5, 7] = float("nan")
                with autograd.train_mode():
                    net(mx.np.array(bad, device=dev))
                torch.cuda.synchronize()
                try:
                    monitor.check()
                except mx.MXNetError as e:
                    found = str(e)
        finally:
            monitor.uninstall_nan_hook()
            monitor.clear_nan_findings()
        return counts, caps, found

    plain_counts, plain_caps, _ = hybrid(False)
    hook_counts, hook_caps, found = hybrid(True)
    log(f"[observe monitor] hybridize capture without the hook: launches "
        f"{plain_counts}, captures {plain_caps}; with install_nan_hook: "
        f"launches {hook_counts}, captures {hook_caps}; a NaN replay: "
        f"{found!r}")
    check(hook_caps == plain_caps == 1 and hook_counts == plain_counts,
          "[observe monitor] the hook changed the capture or its launches")
    check(found is not None and "(graph)" in found,
          "[observe monitor] a NaN replay under the hook went unseen")
    return dict(eager=card_msg, launches=hook_counts, graph=found)


def phase_observe_audit(torch, dev, mx):
    """The auditor: one step of the eager float16 loop ([amp16]) yields a
    host-sync finding at LossScaler.has_overflow; the hybridized BERT
    block has none."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam

    model = bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                      seed=0)
    trainer = Trainer(model.collect_params(), Adam(learning_rate=TRAIN_LR))
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    labels = torch.randint(0, BERT_VOCAB, (TRAIN_B, TRAIN_T), generator=g,
                           device=dev)
    ce = SoftmaxCrossEntropyLoss()
    amp.scale_loss._scaler = scaler = amp.LossScaler()
    params = model.collect_params()

    def f16_step(tokens, labels):
        grads_to_none(model)
        amp.init("float16")
        try:
            with autograd.train_mode():
                loss = ce(model(tokens)[0].float(), labels)
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward(torch.ones_like(scaled))
        finally:
            amp.deinit()
        if scaler.has_overflow(params):
            scaler.update_scale(True)
        else:
            scaler.update_scale(False)
            trainer.step(TRAIN_B)

    rep = mx.analysis.audit(f16_step, tokens, labels)
    log(f"[observe audit] one eager float16 step: {rep.summary()}")
    sites = [f.site or "" for f in rep.by_kind("host-sync")]
    check(any("LossScaler.has_overflow" in s for s in sites),
          f"[observe audit] no host-sync finding at LossScaler.has_overflow "
          f"({sites})")
    del trainer
    model.hybridize()
    nd_tokens = mx.nd.NDArray(tokens)
    for _ in range(2):                          # eager, capture
        model(nd_tokens)
    torch.cuda.synchronize()
    rep2 = model.audit(nd_tokens)
    log(f"[observe audit] the hybridized BERT block: {rep2.summary()}; "
        f"abstract pass ran {len(rep2.jaxpr or [])} funnel ops")
    check(not rep2.by_kind("host-sync"), "[observe audit] the hybridized "
          "BERT block has a host-sync finding")
    out = dict(f16_step=[repr(f) for f in rep],
               f16_sites=sites,
               bert_hybridized=[repr(f) for f in rep2._all])
    del model
    return out


def phase_observe_peaks(torch, dev, smi):
    """A device-to-device copy's GB/s and a bf16 cuBLAS product's TFLOP/s,
    beside the data-sheet peaks the tables and bounds keep."""
    from incubator_mxnet_tpu_torch.telemetry import kernels, roofline

    src = torch.empty(OBS_COPY_BYTES // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    src.normal_()
    copy_ms = time_ms(lambda: dst.copy_(src), [()], 20)
    gbs = 2 * OBS_COPY_BYTES / (copy_ms / 1e3) / 1e9
    del src, dst
    n = OBS_GEMM_N
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    gemm_ms = time_ms(lambda: a @ b, [()], 20)
    tflops = 2 * n ** 3 / (gemm_ms / 1e3) / 1e12
    del a, b
    card = smi.split(",")[0].strip().lower()
    sheet_gbs = roofline.PEAK_HBM_GBS.get(card)
    sheet_tf = kernels.PEAK_TFLOPS.get(card)
    log(f"[observe peaks] {smi}: a {OBS_COPY_BYTES >> 20} MiB device copy "
        f"{copy_ms:.4f} ms -> {gbs:.1f} GB/s (read + write; data sheet "
        f"{sheet_gbs} GB/s, the tables' roof); a bf16 {n}^3 cuBLAS product "
        f"{gemm_ms:.4f} ms -> {tflops:.1f} TFLOP/s (data sheet "
        f"{sheet_tf} TFLOP/s dense, the tables' roof)")
    check(sheet_gbs is not None and sheet_tf is not None,
          f"[observe peaks] no table entry for the card {card!r}")
    return dict(copy_gbs=gbs, copy_ms=copy_ms, gemm_tflops=tflops,
                gemm_ms=gemm_ms, sheet_gbs=sheet_gbs, sheet_tflops=sheet_tf)


def phase_observe(torch, dev):
    """[observe]: the profiler and its consumers on the card: the training
    path's census (bench.py:400's cross-check), the serving path's
    profiled decode replay and its Chrome trace, the funnel's stages, the
    NaN hook, the auditor, measured peaks. Returns (numbers, launches
    through the wrappers)."""
    import incubator_mxnet_tpu_torch as mx

    smi = _obs_smi()
    card = smi.split(",")[0].strip()
    t0 = time.perf_counter()
    reset_counts()
    res = {"card": smi}
    res["train"] = phase_observe_train(torch, dev, card, smi)
    torch.cuda.empty_cache()
    res["serve"] = phase_observe_serve(torch, dev)
    torch.cuda.empty_cache()
    res["stages"] = phase_observe_stages(torch, mx)
    res["monitor"] = phase_observe_monitor(torch, dev, mx)
    torch.cuda.empty_cache()
    res["audit"] = phase_observe_audit(torch, dev, mx)
    torch.cuda.empty_cache()
    res["peaks"] = phase_observe_peaks(torch, dev, smi)
    torch.cuda.empty_cache()
    launches, layouts = read_counts(), read_layout_counts()
    res["seconds"] = time.perf_counter() - t0
    log(f"[observe] phase took {res['seconds']:.1f} s; launches through "
        f"the wrappers {launches}")
    return res, launches, layouts


# ---------------------------------------------------------------------------
# [fit]: BERT-base fine-tuned through Estimator.fit, fed by a DataLoader
# with worker processes
# ---------------------------------------------------------------------------

FIT_ROWS, FIT_VAL_ROWS, FIT_T, FIT_B = 2048, 256, 128, 32
FIT_BATCHES, FIT_VAL_PERIOD, FIT_CK_EVERY, FIT_CK_KEEP = 64, 32, 16, 2
FIT_PREEMPT_AT, FIT_CRASH_AT, FIT_PLAIN_BATCHES = 40, 50, 4
FIT_SEED, FIT_LR, FIT_WORKERS = 19, 5e-5, 2
# the first batches' mean losses, kernels against plain versions, under
# bf16 AMP: the same cuBLAS products; K1/K2 round P and dS at the running
# max (the plain version at the final max) and the row kernels sum in
# another order, through 12 layers of bf16 products: relative, the
# normwise bound of `tests/test_torch_amp.py` (ND_AMP_TOL)
FIT_LOSS_TOL = 2.0 ** -5
# kernel launches of one training step of BERTClassifier over BERT-base's
# encoder at p = 0.1 (no MLM head): K4 at the embedding LayerNorm, K3 at
# the 24 post-LN sites, K5 at the embedding, 12 attention-output, 12
# FFN-hidden sites and the classifier's dropout, forward and backward; a
# K2 call is 3 kernels, a K4b or K3 backward call 2 (row kernel and
# dgamma/dbeta reduction); the replayed forward folds the step's 26 site
# keys in one fold launch (ops.dropout.KEY_CHUNK = 64 sites a fold)
FIT_STEP_LAUNCHES = {"K1": 12, "K2": 12 * 3, "K4": 1, "K4b": 1 * 2,
                     "K3f": 24, "K3b": 24 * 2, "K5": 26 * 2, "K6f": 0,
                     "K6b": 0, "fold": 1}
# one validation batch (predict mode: no dropout, no backward)
FIT_EVAL_LAUNCHES = {"K1": 12, "K2": 0, "K4": 1, "K4b": 0, "K3f": 24,
                     "K3b": 0, "K5": 0, "K6f": 0, "K6b": 0, "fold": 0}
# the launch log's tags of a step (K3's forward and K4 share
# ln_fwd_kernel, their backwards ln_bwd_kernel and its reduction)
FIT_LOG_TAGS = {"flash_fwd_kernel": ("K1",), "flash_bwd_delta_kernel":
                ("K2",), "flash_bwd_dq_kernel": ("K2",),
                "flash_bwd_dkv_kernel": ("K2",),
                "ln_fwd_kernel": ("K4", "K3f"),
                "ln_bwd_kernel": ("K4b", "K3b"),
                "ln_partials_reduce_kernel": ("K4b", "K3b"),
                "dropout_kernel": ("K5",), "fold_keys_kernel": ("fold",)}


def _log_counts(expected):
    """{launch-log tag: count} that ``expected`` (counter units) gives:
    a K4b or K3b count is two log entries, one of each tag."""
    out = {}
    for tag, classes in FIT_LOG_TAGS.items():
        n = sum(expected.get(c, 0) for c in classes)
        if tag in ("ln_bwd_kernel", "ln_partials_reduce_kernel"):
            n //= 2
        if tag.startswith("flash_bwd"):
            n //= 3
        out[tag] = n
    return out


def _tally(log_entries):
    """{tag: count} of a launch log (a replay's entry is its capture's
    list)."""
    out = {}
    for e in log_entries:
        for k in (e if isinstance(e, list) else [e]):
            out[k[0]] = out.get(k[0], 0) + 1
    return out


def fit_data(onp, rows, seed):
    """Seeded token rows (int32, FIT_T long) and their labels by a fixed
    rule of the tokens (whether the second token lies in the vocabulary's
    lower half), so that accuracy can move."""
    r = onp.random.RandomState(seed)
    tok = r.randint(0, BERT_VOCAB, (rows, FIT_T)).astype("int32")
    return tok, (tok[:, 1] < BERT_VOCAB // 2).astype("int32")


def _fit_net(dev, impl="auto"):
    from incubator_mxnet_tpu_torch.models.bert import (BERTClassifier,
                                                        bert_base)

    enc = bert_base(max_length=FIT_T, dropout=TRAIN_P, device=dev, seed=0,
                    impl=impl).encoder
    return BERTClassifier(enc, 2, dropout=TRAIN_P, device=dev, seed=1,
                          impl=impl)


def _fit_states(trainer):
    return [None if s is None else [t.detach().clone() for t in s]
            for s in trainer._states]


def _same_states(a, b):
    """Two Trainers' optimizer states (`_fit_states`) bit for bit."""
    import torch

    return len(a) == len(b) and all(
        (x is None) == (y is None) and (x is None or (
            len(x) == len(y) and all(torch.equal(u, v)
                                     for u, v in zip(x, y))))
        for x, y in zip(a, b))


def phase_fit_run(torch, dev, mx, loader, val, ckdir):
    """The kernel path's fit: the handlers of the slice, the preemption at
    FIT_PREEMPT_AT, the crash at FIT_CRASH_AT; returns its records."""
    import os

    import numpy as onp

    from incubator_mxnet_tpu_torch import gluon, preemption
    from incubator_mxnet_tpu_torch.fault import injection
    from incubator_mxnet_tpu_torch.fault.resilience import ResilienceHandler
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as E
    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.telemetry import goodput, registry
    from incubator_mxnet_tpu_torch.telemetry.monitor import TelemetryHandler

    net = _fit_net(dev)
    net.hybridize(static_alloc=True, static_shape=True)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": FIT_LR})
    est = E.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                      train_metrics=[gluon.metric.Accuracy()],
                      trainer=trainer)
    ck = preemption.TrainingCheckpointer(
        os.path.join(ckdir, "fit"), net, trainer, every_n=FIT_CK_EVERY,
        keep=FIT_CK_KEEP)
    rec = dict(losses=[], batches=[], walls=[], events=[], captures=[],
               preempt=None, evals=0, resumed=[], keys=[])
    resume = ck.resume

    def recorded_resume():
        rec["resumed"].append(resume())
        return rec["resumed"][-1]

    ck.resume = recorded_resume

    class Record(E.event_handler.BatchBegin, E.event_handler.BatchEnd):
        """Each batch's host copy (at batch_begin: a crashed batch
        too), each step's wall and CUDA-event interval, the loss, the
        captures (first of the batch_end handlers)."""

        def __init__(self):
            self.priority = -2000

        def batch_begin(self, estimator, *args, **kwargs):
            b = kwargs["batch"]
            rec["batches"].append((b[0]._data.cpu(), b[1]._data.cpu()))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.t0, self.ev0 = time.perf_counter(), ev

        def batch_end(self, estimator, *args, **kwargs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["losses"].append(float(kwargs["loss"].mean().item()))
            rec["walls"].append((time.perf_counter() - self.t0) * 1e3)
            rec["events"].append((self.ev0, ev))
            rec["captures"].append(net.captures)
            # the key buffer of the step's replay (None: the eager first
            # call, whose keys went by value)
            train = [e for sig, e in net._cached_graph.entries.items()
                     if sig[1] and e.fwd is not None]
            rec["keys"].append(train[0].key.tolist() if train else None)

    class Preempt(E.event_handler.BatchEnd):
        """After the checkpointer's cadence (last of the batch_end
        handlers): the preemption at FIT_PREEMPT_AT, resumed at once by a
        fresh net and Trainer and held to the live state; the crash armed
        for FIT_CRASH_AT."""

        def __init__(self):
            self.n = 0
            self.priority = 100

        def batch_end(self, estimator, *args, **kwargs):
            self.n += 1
            if self.n == FIT_CRASH_AT - 1:
                injection.configure_injection("estimator_step:1.0:0:1")
            if self.n != FIT_PREEMPT_AT:
                return
            preemption.trigger()
            path = ck._mgr.latest()
            fresh = _fit_net(dev)
            ftr = gluon.Trainer(fresh.collect_params(), "adam",
                                {"learning_rate": FIT_LR})
            step = preemption.TrainingCheckpointer(
                os.path.join(ckdir, "fit"), fresh, ftr,
                register_signal=False).resume()
            live = net.collect_params()
            rec["preempt"] = dict(
                step=step, path=path, live_step=ck._mgr._step,
                params=all(torch.equal(p.data()._data,
                                       live[k].data()._data)
                           for k, p in fresh.collect_params().items()),
                states=_same_states(_fit_states(ftr), _fit_states(trainer)),
                num_update=(ftr.optimizer.num_update,
                            trainer.optimizer.num_update))

    def evaluate(*args, **kwargs):
        rec["evals"] += 1
        return est.evaluate(*args, **kwargs)

    handlers = [Record(), Preempt(), E.LoggingHandler(),
                E.ValidationHandler(val, evaluate,
                                    batch_period=FIT_VAL_PERIOD),
                E.CheckpointHandler(ckdir, max_checkpoints=FIT_CK_KEEP),
                TelemetryHandler(), ResilienceHandler(ck)]
    resumes = registry.counter("mx_resumes_total").value
    goodput.reset()
    goodput.enable()
    mx.random.seed(FIT_SEED)
    onp.random.seed(FIT_SEED)
    _build.LAUNCH_LOG = log = []
    t0 = time.perf_counter()
    try:
        est.fit(loader, batches=FIT_BATCHES, event_handlers=handlers)
        torch.cuda.synchronize()
    finally:
        _build.LAUNCH_LOG = None
        injection.clear_injection()
        preemption.clear_preemption_hooks()
        goodput.disable()
    rec["fit_s"] = time.perf_counter() - t0
    rec["goodput"] = goodput.report()
    rec["log"] = _tally(log)
    rec["resumes"] = registry.counter("mx_resumes_total").value - resumes
    rec["resumes_total"] = registry.counter("mx_resumes_total").value
    rec["resumed_to"] = rec["resumed"]
    rec["metrics"] = {m.name: float(m.get()[1])
                      for m in est.train_metrics + est.val_metrics}
    rec["captures_end"] = net.captures
    rec["entries"] = len(net._cached_graph.entries)
    return net, trainer, est, rec


def phase_fit(torch, dev):
    """[fit]: BERT-base (768 units, 12 layers, 12 heads, FFN 3072, vocab
    30522) in ``BERTClassifier(num_classes=2, dropout=0.1)``, seeded,
    hybridized, under bf16 AMP, ``Trainer("adam")``, fine-tuned through
    ``Estimator.fit(batches=64)`` on FIT_ROWS seeded rows of 128 tokens,
    fed by ``DataLoader(batch_size=32, shuffle=True, num_workers=2,
    last_batch="discard", pin_memory=True)``, with LoggingHandler,
    ValidationHandler (every 32 batches, FIT_VAL_ROWS rows),
    CheckpointHandler, TelemetryHandler and ResilienceHandler over a
    TrainingCheckpointer (every 16 steps). It checks each kernel's
    launches (the launch log over the fit, the census of a profiled
    step) against FIT_STEP_LAUNCHES a step, one training and one
    predict-mode capture, the first FIT_PLAIN_BATCHES losses against the
    same fit on the plain versions, the first epoch's batches against the
    loader run without workers on the CPU, a preemption at batch 40
    resumed bit for bit by a fresh net and Trainer, and a crash injected
    at batch 50 recovered. Returns (numbers, launches through the
    wrappers)."""
    import shutil
    import tempfile

    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, autograd, gluon
    from incubator_mxnet_tpu_torch.gluon.block import _CachedGraph
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as E

    t_phase = time.perf_counter()
    tok, lab = fit_data(onp, FIT_ROWS, FIT_SEED)
    vtok, vlab = fit_data(onp, FIT_VAL_ROWS, FIT_SEED + 1)
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(tok, lab), batch_size=FIT_B, shuffle=True,
        num_workers=FIT_WORKERS, last_batch="discard", pin_memory=True)
    val = gluon.data.DataLoader(gluon.data.ArrayDataset(vtok, vlab),
                                batch_size=FIT_B, last_batch="discard")
    ckdir = tempfile.mkdtemp(prefix="mx_fit_")
    amp.init("bfloat16")
    try:
        reset_counts()
        net, trainer, est, rec = phase_fit_run(torch, dev, mx, loader, val,
                                               ckdir)
        launches, layouts = read_counts(), read_layout_counts()
        # the preemption: a fresh net and Trainer resumed bit for bit
        pre = rec["preempt"]
        check(pre is not None and pre["step"] == pre["live_step"]
              == FIT_PREEMPT_AT
              and pre["path"].endswith(f"-{FIT_PREEMPT_AT:07d}.ckpt")
              and pre["params"] and pre["states"]
              and pre["num_update"][0] == pre["num_update"][1],
              f"[fit] the preemption at batch {FIT_PREEMPT_AT}: {pre}")
        torch.cuda.empty_cache()
        # the crash
        check(rec["resumes"] == 1 and rec["resumed_to"] == [
                  FIT_CK_EVERY * ((FIT_CRASH_AT - 1) // FIT_CK_EVERY)]
              and math.isfinite(rec["losses"][-1]),
              f"[fit] the crash at batch {FIT_CRASH_AT}: resumes "
              f"{rec['resumes']}, resumed to step {rec['resumed_to']}, last "
              f"loss {rec['losses'][-1]}")
        # launches: the launch log over the fit, the census of one step
        # steps + the capture's warm-up, less the eager first step's fold
        # (its keys go by value), and the validation batches + theirs
        steps = len(rec["losses"])
        vbatches = rec["evals"] * (FIT_VAL_ROWS // FIT_B)
        want = {k: FIT_STEP_LAUNCHES[k] * (steps + 1)
                + FIT_EVAL_LAUNCHES[k] * (vbatches + 1)
                for k in FIT_STEP_LAUNCHES}
        want["fold"] -= FIT_STEP_LAUNCHES["fold"]
        want_log = _log_counts(want)
        check(rec["log"] == want_log,
              f"[fit] the launch log over the fit {rec['log']} is not "
              f"{steps} steps + the capture's warm-up of FIT_STEP_LAUNCHES "
              f"and {vbatches} validation batches + its warm-up of "
              f"FIT_EVAL_LAUNCHES: {want_log}")
        batch = (mx.nd.array(tok[:FIT_B], device=dev),
                 mx.nd.array(lab[:FIT_B], device=dev))
        assert batch[0].dtype == onp.int32

        def one_step():
            est.fit_batch(batch)
            trainer.step(FIT_B)

        cen = profiled(torch, one_step)
        step_census, _ = census_launches(cen)
        check(step_census == FIT_STEP_LAUNCHES,
              f"[fit] the census of a replayed step {step_census} is not "
              f"FIT_STEP_LAUNCHES {FIT_STEP_LAUNCHES}")
        busy_ms = census_ms(cen)
        check(rec["captures"][1] == 1 and rec["captures_end"] == 2
              and rec["entries"] == 2,
              f"[fit] captures after each batch {rec['captures'][:4]}..., "
              f"{rec['captures_end']} at the end over {rec['entries']} "
              f"signatures (one training, one predict-mode)")
        check(all(n > 0 for k, n in launches.items()
                  if FIT_STEP_LAUNCHES[k]),
              f"[fit] a kernel of the path was not launched: {launches}")
        # the loader: the first epoch against no workers on the CPU
        n_epoch = FIT_ROWS // FIT_B
        onp.random.seed(FIT_SEED)
        with mx.cpu():
            cpu = [(b[0]._data, b[1]._data) for b in gluon.data.DataLoader(
                gluon.data.ArrayDataset(tok, lab), batch_size=FIT_B,
                shuffle=True, num_workers=0, last_batch="discard")]
        same_loader = len(rec["batches"]) >= n_epoch and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(rec["batches"][:n_epoch], cpu))
        check(same_loader, "[fit] the first epoch's batches on the card "
              "differ from the loader's without workers on the CPU")
        # the plain versions: the same fit's first batches. Their fold of
        # the keys copies from the host, which a capture refuses: each
        # step runs the captured function eagerly with the key buffer the
        # kernel path's replay of that step read (the first, eager, step
        # draws the same keys by value from the same seed)
        plain = _fit_net(dev, impl="plain")
        twin = _CachedGraph(plain)
        keys = iter(rec["keys"])

        class PlainEstimator(E.Estimator):
            def fit_batch(self, train_batch, batch_axis=0):
                data, label = self._get_data_and_label(train_batch,
                                                       batch_axis)
                k = next(keys)
                with autograd.record():
                    pred = plain(data) if k is None else \
                        twin.eager((data,), k[:2], k[2])
                    loss = self.loss(pred, label)
                loss.backward()
                return data, label, pred, loss

        pest = PlainEstimator(plain, gluon.loss.SoftmaxCrossEntropyLoss(),
                              train_metrics=[gluon.metric.Accuracy()],
                              trainer=gluon.Trainer(
                                  plain.collect_params(), "adam",
                                  {"learning_rate": FIT_LR}))
        plosses = []

        class Losses(E.event_handler.BatchEnd):
            def batch_end(self, estimator, *args, **kwargs):
                plosses.append(float(kwargs["loss"].mean().item()))

        mx.random.seed(FIT_SEED)
        onp.random.seed(FIT_SEED)
        pest.fit(loader, batches=FIT_PLAIN_BATCHES,
                 event_handlers=[Losses()])
        rel = [abs(a - b) / abs(b) for a, b in
               zip(rec["losses"][:FIT_PLAIN_BATCHES], plosses)]
        check(len(plosses) == FIT_PLAIN_BATCHES and max(rel) <= FIT_LOSS_TOL,
              f"[fit] the first {FIT_PLAIN_BATCHES} losses on the kernels "
              f"{rec['losses'][:FIT_PLAIN_BATCHES]} against the plain "
              f"versions {plosses}: relative {rel} > {FIT_LOSS_TOL}")
        del plain, pest, twin
    finally:
        amp.deinit()
        shutil.rmtree(ckdir, ignore_errors=True)
    walls = rec["walls"][2:]
    dev_ms = [a.elapsed_time(b) for a, b in rec["events"][2:]]
    med = _median(walls)
    gp = rec["goodput"]
    secs = gp.get("states", {})
    out = dict(
        steps=len(rec["losses"]), batch=FIT_B, tokens=FIT_T,
        loss_first=rec["losses"][0], loss_last=rec["losses"][-1],
        metrics=rec["metrics"], plain_losses=plosses,
        kernel_losses=rec["losses"][:FIT_PLAIN_BATCHES],
        loss_rel_vs_plain=max(rel), loss_tol=FIT_LOSS_TOL,
        median_step_wall_ms=med, median_step_event_ms=_median(dev_ms),
        step_busy_ms=busy_ms,
        idle_share=1 - busy_ms / med if busy_ms > 0 else None,
        examples_per_s=FIT_B / (med / 1e3),
        fit_s=rec["fit_s"], goodput_s={k: secs.get(k) for k in
                                       ("compute", "data_wait",
                                        "checkpoint", "recovery", "idle")},
        accounted_frac=gp.get("accounted_frac"), launch_log=rec["log"],
        step_census=step_census, captures=rec["captures_end"],
        preempt_resume_step=rec["preempt"]["step"],
        validations=rec["evals"], resumes=rec["resumes"],
        resumes_total=rec["resumes_total"], loader_equal=same_loader,
        workers=FIT_WORKERS, seconds=time.perf_counter() - t_phase)
    log(f"[fit] {out['steps']} steps of BERTClassifier(BERT-base) at "
        f"{FIT_B} x {FIT_T}, bf16 AMP, Adam, hybridized: loss "
        f"{out['loss_first']:.4f} -> {out['loss_last']:.4f}, metrics "
        f"{rec['metrics']}; median step {med:.2f} ms wall, "
        f"{out['median_step_event_ms']:.2f} ms between CUDA events, "
        f"{busy_ms:.2f} ms busy (census) -> idle share "
        + (f"{out['idle_share']:.4f}" if out["idle_share"] is not None
           else "not measured")
        + f"; {out['examples_per_s']:.1f} examples/s")
    log(f"[fit] goodput {out['goodput_s']} s, accounted "
        f"{out['accounted_frac']}; fit {rec['fit_s']:.1f} s")
    log(f"[fit] launch log {rec['log']}; census of a step {step_census}; "
        f"captures {rec['captures_end']}; losses vs plain relative "
        f"{max(rel):.2e} (tol {FIT_LOSS_TOL:g}); preemption resumed bit "
        f"for bit at {FIT_PREEMPT_AT}; crash resumed to step "
        f"{rec['resumed_to']} (mx_resumes_total {rec['resumes_total']}); "
        f"loader equal to the CPU's: {same_loader}; phase "
        f"{out['seconds']:.1f} s")
    del net, trainer, est, loader
    torch.cuda.empty_cache()
    return out, launches, layouts


# ---------------------------------------------------------------------------
# [pipeline]: bench.py:239's input pipeline on the port
# ---------------------------------------------------------------------------

PIPE_IMAGES, PIPE_SIZE, PIPE_B, PIPE_EPOCHS, PIPE_SEED = 512, 256, 64, 2, 0


def _pipe_iter(mxio, rec_path, rand):
    return mxio.ImageRecordIter(path_imgrec=rec_path,
                                data_shape=(3, 224, 224), batch_size=PIPE_B,
                                shuffle=True, rand_crop=rand,
                                rand_mirror=rand, preprocess_threads=8,
                                prefetch_buffer=4)


def phase_pipeline(torch, dev):
    """[pipeline]: ``bench.py:239``'s ``bench_input_pipeline`` on the port
    as written there: PIPE_IMAGES seeded 256² images packed with
    ``recordio.pack_img`` (quality 90) into an ``MXIndexedRecordIO``, then
    ``io.ImageRecordIter(data_shape=(3, 224, 224), batch_size=64,
    shuffle=True, rand_crop=True, rand_mirror=True, preprocess_threads=8,
    prefetch_buffer=4)``: the best images/s over 2 epochs after a warm
    one. It runs no kernel of the port. It checks that the native reader
    (librtio, built by g++) read the records and that one batch's pixels
    on the card (the uint8 batch uploaded, cast and transposed there)
    equal the CPU iterator's for the same seeds; that check takes the
    center crop, since the random crop's draws come from the 8 decode
    threads in no fixed order, in either package."""
    import os as _os
    import random
    import shutil
    import tempfile

    import numpy as onp

    from incubator_mxnet_tpu_torch import _native, image
    from incubator_mxnet_tpu_torch import io as mxio
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import recordio

    t0 = time.perf_counter()
    rng = onp.random.RandomState(PIPE_SEED)
    d = tempfile.mkdtemp(prefix="mx_pipe_")
    rec_path = _os.path.join(d, "imgs.rec")
    try:
        w = recordio.MXIndexedRecordIO(_os.path.join(d, "imgs.idx"),
                                       rec_path, "w")
        for i in range(PIPE_IMAGES):
            img = rng.randint(0, 255, (PIPE_SIZE, PIPE_SIZE, 3),
                              dtype=onp.uint8)
            w.write_idx(i, recordio.pack_img(
                recordio.IRHeader(0, float(i % 10), i, 0), img, quality=90))
        w.close()
        rtio = _native.rtio() is not None
        calls, codecs = _native.native_calls, dict(image.decode_counts)
        it = _pipe_iter(mxio, rec_path, True)
        try:
            rates = []
            for _ in range(PIPE_EPOCHS + 1):   # the first warms the pools
                cnt = 0
                t1 = time.perf_counter()
                for b in it:
                    b.data[0].wait_to_read()
                    cnt += b.data[0].shape[0]
                rates.append(cnt / (time.perf_counter() - t1))
                it.reset()
        finally:
            it.close()
        native_reads = _native.native_calls - calls
        used = {k: image.decode_counts[k] - codecs[k] for k in codecs
                if image.decode_counts[k] > codecs[k]}
        check(rtio and native_reads > 0,
              f"[pipeline] the native reader was not used: librtio loaded "
              f"{rtio}, {native_reads} native batch reads")
        check(b.data[0].shape == (PIPE_B, 3, 224, 224)
              and b.data[0]._data.device.type == "cuda"
              and b.data[0]._data.dtype == torch.float32,
              f"[pipeline] a batch is {b.data[0].shape} "
              f"{b.data[0]._data.dtype} on {b.data[0]._data.device}")
        firsts = []
        for scope in (mx.gpu(dev.index or 0), mx.cpu()):
            random.seed(PIPE_SEED)
            onp.random.seed(PIPE_SEED)
            with scope:
                it = _pipe_iter(mxio, rec_path, False)
            try:
                b = next(it)
                firsts.append((b.data[0]._data.cpu(), b.label[0]._data.cpu()))
            finally:
                it.close()
        same = torch.equal(firsts[0][0], firsts[1][0]) and \
            torch.equal(firsts[0][1], firsts[1][1])
        check(same, "[pipeline] a batch's pixels on the card differ from "
              "the CPU iterator's")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = dict(images=PIPE_IMAGES, batch=PIPE_B,
               images_per_s=max(rates[1:]), epoch_images_per_s=rates,
               codec=used, librtio=rtio, native_batch_reads=native_reads,
               host_cores=_os.cpu_count(), batch_equal_cpu=same,
               seconds=time.perf_counter() - t0)
    log(f"[pipeline] {PIPE_IMAGES} images of {PIPE_SIZE}^2 through "
        f"ImageRecordIter (batch {PIPE_B}, rand_crop, rand_mirror, 8 "
        f"threads, prefetch 4): best {out['images_per_s']:.1f} images/s "
        f"over {PIPE_EPOCHS} epochs after a warm one ({rates}); codec "
        f"{used}; librtio loaded {rtio}, {native_reads} native batch "
        f"reads; host cores {out['host_cores']}; a batch equal to the "
        f"CPU's: {same}; no kernel of the port runs here")
    return out


# [dist]: distributed training on the card. (1) an NCCL world of one:
# bench.py:337's BERT-base step (64 x 128, dropout 0.1, Adam, MLM CE,
# bf16 AMP) through DataParallel on a (dp 1, tp 1) mesh with the Megatron
# specs and SP, against the no-mesh DataParallel. (2)-(5) a world of
# DIST_WORLD ranks, processes on the same card: NCCL refuses a second rank
# on one device, so the world takes gloo (CUDA tensors exchanged through
# host memory), BERT-base at full width over dp 2 x tp 2 with TP + SP,
# each rank storing its blocks of the cut parameters (2), ring attention
# over sp (3), one dp replica leaving the BERT-base run (4: the elastic
# transition, resharding and the resume of its checkpoint on 2 ranks),
# GPipe over pp and top-2 MoE over ep (5).
DIST_WORLD = 4
DIST_B, DIST_STEPS = 16, 3            # (2): the global batch, Adam steps
DIST_LOSS_REL = 1e-4                  # (2) against the no-mesh step
DIST_RING = dict(b=1, h=12, t=32768, d=64)
DIST_PIPE = dict(width=768, micro=4, rows=64, lr=0.05, steps=3)
DIST_MOE = dict(units=768, hidden=FFN, experts=4, cf=1.25, tokens=8 * 128,
                lr=0.5, steps=3)
DIST_F32_REL = 1e-4                   # GPipe and MoE against one rank
DIST_TIMEOUT_S = 600
DIST_NEAR_ZERO = 1e-3   # a gradient this far below its leaf's largest


def _dist_batch(torch, dev, b):
    """(tokens, labels) of BERT-base, (b, TRAIN_T), from a CPU generator
    seeded 0 (the same in every process)."""
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randint(0, BERT_VOCAB, (b, TRAIN_T), generator=g)
                 .to(dev) for _ in range(2))


def _dist_ring_inputs(torch, dev):
    """q, k, v, dO (B, H, T, d) bf16 from a CPU generator seeded 1."""
    g = torch.Generator().manual_seed(1)
    r = DIST_RING
    return [torch.randn(r["b"], r["h"], r["t"], r["d"], generator=g)
            .to(dev, torch.bfloat16) for _ in range(4)]


def _digest(tensors):
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _mlm(ce):
    def f(out, y):
        return ce(out[0], y)
    return f


def _dist_hop_checks(torch, fa, q, k, v, do, o, lse, causal):
    """One hop of the ring on its own: K1 and K2 at the ring's shapes
    (one rank's block of DIST_RING's sequence, bhtd bf16) against their
    plain versions on the same inputs. The second rank's queries attend to
    the first block in full and (``causal``) to their own block causally,
    the two kinds of hop the ring runs; K2 is given the whole sequence's
    O and lse for those queries (``o``, ``lse`` from one K1 call), as the
    ring's backward gives it the merged ones. Returns the errors a
    hop."""
    c = DIST_RING["t"] // DIST_WORLD
    rows = slice(c, 2 * c)
    qb, dob, ob = (x[:, :, rows].contiguous() for x in (q, do, o))
    lseb = lse[:, rows].contiguous()
    out = {}
    for src, mode in ((0, False),) + (((1, True),) if causal else ()):
        kb, vb = (x[:, :, src * c:(src + 1) * c].contiguous()
                  for x in (k, v))
        got = (tuple(fa.flash_attention_with_lse(qb, kb, vb, causal=mode))
               + tuple(fa.flash_attention_bwd(qb, kb, vb, ob, lseb, dob,
                                              causal=mode)))
        want = (tuple(fa.plain_attention(qb, kb, vb, causal=mode))
                + tuple(fa.plain_attention_bwd(qb, kb, vb, ob, lseb, dob,
                                               causal=mode)))
        errs = {}
        for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
            ok, err, nrel, top = agree_attn(g, w, ATTN_TOL)
            check(ok, f"[dist 3] one hop, queries of block 1 against block "
                  f"{src} (causal={mode}), ring causal={causal}: {name} "
                  f"against the plain version: max abs {err:.3e}, normwise "
                  f"{nrel:.3e}, max/top {top:.3e} ("
                  + (tol_text("float32", ATTN_TOL) if name == "lse" else
                     tol_text("bfloat16", ATTN_TOL, attn=True)) + ")")
            errs[name] = dict(max_abs=err, normwise=nrel, top=top)
        del got, want
        torch.cuda.empty_cache()
        key = f"block {src} causal={mode}"
        out[key] = errs
        log(f"[dist 3] one hop at the ring's shapes (B={DIST_RING['b']} "
            f"H={DIST_RING['h']} {c} queries x {c} keys, d={DIST_RING['d']}"
            f", bhtd bf16), queries of block 1 against block {src} "
            f"(causal={mode}), K2 given the whole causal={causal} "
            f"sequence's O and lse: K1 and K2 against their plain versions: "
            + "; ".join(f"{n} max abs {e['max_abs']:.3e}, normwise "
                        f"{e['normwise']:.3e}" for n, e in errs.items())
            + f" (o, dq, dk, dv {tol_text('bfloat16', ATTN_TOL, attn=True)}"
            f"; lse {tol_text('float32', ATTN_TOL)})")
    return out


def _dist_world_of_one(torch, dev, store):
    """(1): returns (numbers, launches, layouts)."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import (bert_base,
                                                       tp_param_shardings)
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import (DataParallel, dist,
                                                    make_mesh)

    dist.initialize(init_method=f"file://{store}", num_processes=1,
                    process_id=0, backend="nccl")
    check(dist.is_initialized()
          and torch.distributed.get_backend() == "nccl",
          "[dist] the NCCL world of one did not start")
    ce = SoftmaxCrossEntropyLoss()
    try:
        mesh = make_mesh({"dp": 1, "tp": 1})
        nets = [bert_base(max_length=TRAIN_T, dropout=TRAIN_P, device=dev,
                          seed=0, seq_shard_axis=ax) for ax in ("tp", None)]
        dps = [DataParallel(nets[0], _mlm(ce), Adam(learning_rate=TRAIN_LR),
                            mesh=mesh,
                            param_shardings=tp_param_shardings(nets[0])),
               DataParallel(nets[1], _mlm(ce), Adam(learning_rate=TRAIN_LR))]
        tokens, labels = _dist_batch(torch, dev, TRAIN_B)
        amp.init("bfloat16")
        try:
            out, after = [], []
            for dp, net in zip(dps, nets):
                mxrandom.seed(0)
                losses, counts, layouts, walls = [], [], [], []
                for _ in range(3):
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses.append(dp.step(tokens, labels))
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    counts.append(read_counts())
                    layouts.append(read_layout_counts())
                out.append((losses, counts, layouts, walls))
                after.append([p.detach().clone() for p in net.parameters()])
            # a replay's wall time and device busy time (mesh step)
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dps[0].step(tokens, labels)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            cen = profiled(torch, lambda: dps[0].step(tokens, labels))
        finally:
            amp.deinit()
        torch.cuda.synchronize()
        (lm, cm, ym, wm), (ln_, cn, yn, _wn) = out
        none = {k: 0 for k in DP_STEP_LAUNCHES}
        for i, (c, y) in enumerate(zip(cm, ym)):
            want = DP_STEP_LAUNCHES if i < 2 else none
            check(c == want and (i == 2 or y == AMP_LAYOUT_LAUNCHES),
                  f"[dist 1] mesh step {i}: launches {c}, by layout {y}; "
                  f"expected {want}")
        check(cm == cn, f"[dist 1] mesh launches {cm} != no-mesh {cn}")
        check(dps[0].captures == 1 and dps[1].captures == 1,
              f"[dist 1] captures {dps[0].captures} (mesh), "
              f"{dps[1].captures} (no mesh); expected one each")
        exact = (all(torch.equal(a, b) for a, b in zip(lm, ln_))
                 and all(torch.equal(a, b) for a, b in zip(*after)))
        loss_rel = max(abs(a.item() - b.item()) / abs(b.item())
                       for a, b in zip(lm, ln_))
        param_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in zip(*after))
        how = ("bit for bit" if exact else
               f"losses within {loss_rel:.3e}, parameters within "
               f"{param_rel:.3e} of their largest magnitude")
        check(exact or (loss_rel <= LOSS_REL_TOL
                        and param_rel <= GRAD_REL_TOL),
              f"[dist 1] the mesh step disagrees with the no-mesh step: "
              f"{how} (tol {LOSS_REL_TOL:g}, {GRAD_REL_TOL:g})")
        seen, _ = census_launches(cen)
        dev_ms = census_ms(cen)
        walls.sort()
        wall = walls[len(walls) // 2]
        idle = 1 - dev_ms / wall if dev_ms > 0 else None
        nccl = sum(r["count"] for r in cen["rows"]
                   if "nccl" in r["name"].lower())
        log(f"[dist 1] NCCL world of one, mesh (dp 1, tp 1), "
            f"tp_param_shardings + seq_shard_axis='tp', BERT-base "
            f"{TRAIN_B} x {TRAIN_T}, dropout {TRAIN_P}, Adam lr "
            f"{TRAIN_LR}, bf16 AMP: losses "
            + ", ".join(f"{v.item():.6f}" for v in lm)
            + f" against the no-mesh DataParallel's "
            + ", ".join(f"{v.item():.6f}" for v in ln_)
            + f": {how}; launches a step {cm[0]} (eager), {cm[1]} "
            f"(capturing), {cm[2]} (replay), as the no-mesh step's; one "
            f"capture each; a profiled replay launched {seen} and {nccl} "
            f"NCCL kernels inside the graph; step ms "
            + ", ".join(f"{t:.2f}" for t in wm)
            + f"; a replay's median wall {wall:.2f} ms, device busy "
            f"{dev_ms:.2f} ms (the kernel census) -> idle share "
            + (f"{idle:.4f}" if idle is not None else "not measured"))
        totals = {k: sum(c[k] for c in cm + cn) for k in DP_STEP_LAUNCHES}
        layouts = {k: {} for k in AMP_LAYOUT_LAUNCHES}
        for y in ym + yn:
            for k, v in y.items():
                for name, n in v.items():
                    layouts[k][name] = layouts[k].get(name, 0) + n
        del dps, nets, after
        torch.cuda.empty_cache()
    finally:
        dist._shutdown()
    torch.cuda.empty_cache()
    numbers = dict(losses_mesh=[v.item() for v in lm],
                   losses_no_mesh=[v.item() for v in ln_],
                   agreement=how, launches_a_step=cm, captures=2,
                   nccl_kernels_in_a_replay=nccl, step_ms=wm,
                   replay_wall_ms=wall, device_busy_ms=dev_ms,
                   idle_share=idle)
    return numbers, totals, layouts


def _dist_spawn(backend, store, out, timeout):
    """The world's DIST_WORLD worker processes (this script with
    ``--dist-worker``) on the card: (return codes, outputs)."""
    import os

    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker",
         str(r), str(DIST_WORLD), store, out, backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(DIST_WORLD)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                o, _ = p.communicate(timeout=max(1.0, deadline -
                                                 time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                o, _ = p.communicate()
                o = (o or "") + "\n(killed at the time limit)"
            outs.append(o or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def phase_dist(torch, dev):
    """[dist] (see the constants above); returns (numbers, launches,
    launches by layout)."""
    import os
    import shutil

    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "dist_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    one, totals, layouts = _dist_world_of_one(
        torch, dev, os.path.join(work, "store_one"))
    t1 = time.perf_counter()
    # NCCL with DIST_WORLD ranks on one card: expected to refuse
    rcs, outs = _dist_spawn("nccl", os.path.join(work, "store_nccl"),
                            work, 120)
    lines = [line.strip() for o in outs for line in o.splitlines()]
    said = ([x for x in lines if "Duplicate GPU" in x]
            or [x for x in lines if "NCCL" in x
                and ("rror" in x or "nvalid" in x)])
    nccl_answer = said[0][:300] if said else None
    log(f"[dist 2] NCCL with {DIST_WORLD} ranks on one card: return codes "
        f"{rcs}; NCCL said: {nccl_answer!r}")
    check(any(rcs) or nccl_answer is None,
          "[dist 2] unexpected: NCCL took several ranks on one card")
    nccl_took = not any(rcs)
    t2 = time.perf_counter()
    rcs, outs = _dist_spawn("gloo", os.path.join(work, "store_gloo"), work,
                            DIST_TIMEOUT_S)
    for r, (rc, o) in enumerate(zip(rcs, outs)):
        for line in o.splitlines():
            if line.startswith("[dist"):
                log(line)
    check(not any(rcs), "[dist] workers failed " + str(rcs) + ":\n" + "\n".join(
        f"--- rank {r} ---\n{o[-3000:]}" for r, (rc, o) in
        enumerate(zip(rcs, outs)) if rc))
    t3 = time.perf_counter()
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(DIST_WORLD)]
    numbers = dict(world_of_one=one, nccl_several_ranks_one_card=dict(
        took=nccl_took, answer=nccl_answer), transport="gloo, CUDA tensors "
        "through host memory")
    # (2) BERT-base over dp 2 x tp 2
    want = res[0]["no_mesh_losses"]
    for r in res:
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["bert_losses"],
                                                      want))
        check(rel <= DIST_LOSS_REL,
              f"[dist 2] rank {r['rank']} losses {r['bert_losses']} vs "
              f"the no-mesh step's {want}: {rel:.3e} > {DIST_LOSS_REL:g}")
    check(all(r["tp_axis"] == "tp" for r in res),
          "[dist 2] the step did not split BERT's compute over tp")
    def replicas_agree(digests):
        """A dp replica's blocks are its twin's bits (ranks r and r + 2),
        the uncut parameters the same on every rank."""
        return (digests[0][0] == digests[2][0]
                and digests[1][0] == digests[3][0]
                and len({d[1] for d in digests}) == 1)

    for s in range(DIST_STEPS):
        digests = [r["bert_digests"][s] for r in res]
        check(replicas_agree(digests), f"[dist 2] step {s}: the replicas' "
              f"stored parameters differ (digests {digests})")
    check(replicas_agree([r["amp_digest"] for r in res]),
          "[dist 2] the bf16 p = 0.1 step: the replicas' parameters differ")
    rel = max(abs(a - b) / abs(b) for a, b in zip(res[0]["bert_losses"],
                                                  want))
    p = res[0]["probe"]
    masks = [r["probe"]["digests"] for r in res]
    for s in range(2):
        rep = [m[s][0] for m in masks]
        sp = [m[s][1] for m in masks]
        check(rep[0] == rep[1] and rep[2] == rep[3] and rep[0] != rep[2],
              f"[dist 2] step {s}: replicated-site masks {rep}: the same on "
              f"a tp pair, another on each dp rank expected")
        check(sp[0] == sp[1] and sp[2] == sp[3],
              f"[dist 2] step {s}: sequence-parallel masks {sp}")
    check(all(r["probe"]["halves_differ"] and r["probe"]["fresh"]
              and abs(r["probe"]["keep"] - (1 - TRAIN_P))
              <= 6 * r["probe"]["keep_sigma"] for r in res),
          f"[dist 2] the dropout contract: {[r['probe'] for r in res]}")
    pr, sr = res[0]["param_rel"], res[0]["sgd_rel"]
    check(pr["max"] <= GRAD_REL_TOL and pr["near_max_abs"] <= pr["near_bound"],
          f"[dist 2] the parameters after {DIST_STEPS} Adam steps against "
          f"the no-mesh step's: {pr['max']:.3e} of the leaf's largest "
          f"magnitude ({pr['leaf']}; tol {GRAD_REL_TOL:g}), "
          f"{pr['near_max_abs']:.3e} where the gradient is near zero (tol "
          f"{pr['near_bound']:g})")
    check(sr["max"] <= GRAD_REL_TOL,
          f"[dist 2] one SGD step's update against the no-mesh step's: "
          f"{sr['max']:.3e} of the leaf's largest ({sr['leaf']}) > "
          f"{GRAD_REL_TOL:g}")
    tpa = res[0]["tp_alone"]
    tpa_rel = abs(tpa["first_loss"] - want[0]) / abs(want[0])
    check(tpa_rel <= DIST_LOSS_REL,
          f"[dist 2] TP alone: first loss {tpa['first_loss']} against the "
          f"no-mesh step's {want[0]}: {tpa_rel:.3e} > {DIST_LOSS_REL:g}")
    wall = sorted(res[0]["bert_walls"][1:])[len(res[0]["bert_walls"][1:])
                                            // 2]
    busy = res[0].get("busy_ms")
    # the idle share against the unprofiled step's wall (the profiler
    # slows gloo's host transport, so the profiled step's wall is longer)
    idle = 1 - busy / wall if busy else None
    idle_profiled = 1 - busy / res[0]["profiled_wall_ms"] if busy else None

    def ex_text(ex):
        return ", ".join(
            f"{a} {c} ({b / 2**20:.1f} MiB of buffers, {w / 2**20:.1f} MiB "
            f"on the wire, {ms:.1f} ms; "
            + " ".join(f"{o} {k}" for o, k in sorted(ops.items())) + ")"
            for a, (c, b, ms, w, ops) in sorted(ex.items()))

    mem = [r["memory"] for r in res]
    for r, m in zip(res, mem):
        stored = m["params"] + m["grads"] + m["optimizer"]
        whole = m["whole_params"]
        layout_whole = 2 * whole + m["optimizer"]
        check(m["params"] < 0.55 * whole and m["grads"] == m["params"]
              and m["optimizer"] == 2 * m["params"],
              f"[dist 2] rank {r['rank']} stores {m['params']} bytes of "
              f"parameters, {m['grads']} of gradients, {m['optimizer']} of "
              f"Adam state, of a whole model's {whole}: not its blocks")
        log(f"[dist 2] rank {r['rank']} stores, counted from its tensors: "
            f"parameters {m['params'] / 1e6:.1f} MB, gradients "
            f"{m['grads'] / 1e6:.1f} MB, Adam state "
            f"{m['optimizer'] / 1e6:.1f} MB: {stored / 1e9:.3f} GB, "
            f"{stored / (4 * whole):.4f} of the whole model's "
            f"{4 * whole / 1e9:.3f} GB; a whole-tensor layout (whole "
            f"parameters and gradients, Adam on the blocks) "
            f"{layout_whole / 1e9:.3f} GB; allocator "
            f"peak {m['peak'] / 1e9:.3f} GB over the run (3 Adam steps from "
            f"the trainer's making; {m['allocated_before'] / 1e9:.3f} GB "
            f"held before it, {m['allocated_after'] / 1e9:.3f} after)")
    log(f"[dist 2] BERT-base ({C} units, {H} heads, FFN {FFN}, {LAYERS} "
        f"layers), global batch {DIST_B} x {TRAIN_T}, f32, dropout 0, Adam "
        f"lr {TRAIN_LR}, {DIST_WORLD} ranks on cuda:0 (gloo), dp 2 x tp 2 "
        f"with TP (the compute split over tp: 6 heads, 1536 FFN units and "
        f"half the vocabulary a rank) + SP: losses {res[0]['bert_losses']} against the no-mesh "
        f"step's {want}: max rel {rel:.3e} (tol {DIST_LOSS_REL:g}); each "
        f"rank stores its blocks of the cut parameters, a dp replica's "
        f"blocks its twin's bits and the uncut parameters every rank's "
        f"after each step; step wall ms "
        + ", ".join(f"{t:.1f}" for t in res[0]["bert_walls"])
        + f" (median of steps 2-{DIST_STEPS}: {wall:.1f}); parameters "
        f"after {DIST_STEPS} steps against the no-mesh step's within "
        f"{pr['max']:.3e} of each leaf's largest magnitude (worst "
        f"{pr['leaf']}, {pr['leaves']} leaves; tol {GRAD_REL_TOL:g}) and, "
        f"at the {pr['near_count']} elements whose first gradient is "
        f"within {DIST_NEAR_ZERO:g} of their leaf's largest, within "
        f"{pr['near_max_abs']:.3e} (tol 2 lr a step, "
        f"{pr['near_bound']:g}); one SGD step at lr 1 (its update the "
        f"reduced gradient) within {sr['max']:.3e} of each leaf's largest "
        f"update of the no-mesh step's (worst {sr['leaf']}; tol "
        f"{GRAD_REL_TOL:g}); a "
        f"profiled step's device busy "
        + (f"{busy:.2f} ms -> idle share {idle:.4f} of the unprofiled "
           f"median wall ({idle_profiled:.4f} of the profiled step's "
           f"{res[0]['profiled_wall_ms']:.1f} ms wall, which the profiler "
           f"stretches)" if busy else "not measured")
        + f"; the last step's exchanges by axis (count, MiB, host ms "
        f"inside them, by op), TP + SP: "
        f"{ex_text(res[0]['exchanges_sp'])}; TP alone (no SP): "
        f"{ex_text(tpa['exchanges'])}, its second step's wall "
        f"{tpa['wall_ms']:.1f} ms, its first loss {tpa_rel:.3e} from the "
        f"no-mesh step's; the bf16 AMP p = {TRAIN_P} step: loss "
        f"{res[0]['amp_loss']:.5f}, the ranks' parameters the same bits; "
        f"K5 at p = {TRAIN_P} on ({DIST_B // 2}, {TRAIN_T}, {C}) a rank: "
        f"keep fraction {p['keep']:.5f} (6 sigma {6 * p['keep_sigma']:.5f}),"
        f" masks the same on a tp pair, others on each dp rank, the "
        f"sequence blocks of a rank's own, a fresh mask each step")
    # (3) ring attention over sp
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
    q, k, v, do = _dist_ring_inputs(torch, dev)
    ring = {}
    for causal in (False, True):
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        o, lse = fa.flash_attention_with_lse(qr, kr, vr, causal=causal)
        o.backward(do)
        hop = _dist_hop_checks(torch, fa, q, k, v, do, o.detach(), lse,
                               causal)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fa.flash_attention_with_lse(q, k, v, causal=causal)
        end.record()
        end.synchronize()
        k1_ms = start.elapsed_time(end)
        got = [torch.cat([r[f"ring_{causal}"][i] for r in res],
                         dim=2).to(dev) for i in range(4)]
        checks = []
        for name, g, want_ in zip(("o", "dq", "dk", "dv"), got,
                                  (o, qr.grad, kr.grad, vr.grad)):
            ok, err, nrel, top = agree_attn(g, want_.detach(), ATTN_TOL)
            checks.append((name, ok, err, nrel, top))
            check(ok, f"[dist 3] ring causal={causal} {name}: max abs "
                  f"{err:.3e}, normwise {nrel:.3e}, max/top {top:.3e} "
                  f"({tol_text('bfloat16', ATTN_TOL, attn=True)})")
        hops = [r[f"ring_hops_{causal}"] for r in res]
        ring_ms = max(r[f"ring_ms_{causal}"] for r in res)
        ring[str(causal)] = dict(
            k1_whole_ms=k1_ms, ring_fwd_ms=ring_ms, hops=hops,
            errors={n: dict(max_abs=e, normwise=nr, top=t)
                    for n, _ok, e, nr, t in checks}, hop_vs_plain=hop)
        log(f"[dist 3] ring attention B={DIST_RING['b']} H={DIST_RING['h']}"
            f" T={DIST_RING['t']} ({DIST_RING['t'] // DIST_WORLD} a rank) "
            f"d={DIST_RING['d']} bf16 causal={causal} over sp = "
            f"{DIST_WORLD}: O, dQ, dK, dV against one K1 / K2 call over "
            f"the whole sequence: "
            + "; ".join(f"{n} max abs {e:.3e}, normwise {nr:.3e}"
                        for n, _ok, e, nr, _t in checks)
            + f" ({tol_text('bfloat16', ATTN_TOL, attn=True)}); K1 and K2 "
            f"launches a rank (forward, backward) {hops}; the ring's "
            f"forward {ring_ms:.2f} ms (slowest rank, CUDA events, with "
            f"its host-memory exchanges) against K1 over the whole "
            f"sequence {k1_ms:.3f} ms")
        del got, qr, kr, vr, o
    del q, k, v, do
    # (5) GPipe and MoE
    for name in ("pipe", "moe"):
        r0 = res[0][name]
        check(r0["rel"] <= DIST_F32_REL,
              f"[dist 5] {name}: against one rank {r0['rel']:.3e} > "
              f"{DIST_F32_REL:g}")
        check(all(r[name]["losses"][-1] < r[name]["losses"][0]
                  for r in res), f"[dist 5] {name}: the loss did not fall "
              f"{[r[name]['losses'] for r in res]}")
        log(f"[dist 5] {r0['what']}: the output against one rank's "
            f"unsharded computation within {r0['rel']:.3e} (tol "
            f"{DIST_F32_REL:g}); {len(r0['losses'])} SGD steps, losses "
            + ", ".join(f"{v:.6f}" for v in r0["losses"]))
    # (4) elastic: one dp replica leaves
    el = [r["elastic"] for r in res]
    check([e["verdict"] for e in el] == ["shrunk", "shrunk", "leave",
                                          "leave"],
          f"[dist 4] verdicts {[e['verdict'] for e in el]}")
    for r, e in zip(res[:2], el[:2]):
        ls, ab, rs = e["losses"], e["aborted"], e["resume"]
        check(e["mesh"] == {"dp": 1, "tp": 2} and e["generation"] == 1,
              f"[dist 4] rank {r['rank']}: mesh {e['mesh']}, generation "
              f"{e['generation']} after the shrink")
        check(e["params_bits"] and e["state_bits"],
              f"[dist 4] rank {r['rank']}: parameters "
              f"{e['params_bits']}, Adam state {e['state_bits']} bit for "
              f"bit the pre-transition ones")
        check(ls[3] < ls[2] < ls[1] < ls[0],
              f"[dist 4] rank {r['rank']}: losses {ls} do not keep falling")
        check(ab is not None and "SC001" in ab["rules"]
              and ab["generation_kept"],
              f"[dist 4] rank {r['rank']}: the pre-flight did not abort on "
              f"silent replication: {ab}")
        check(rs["bits"] and rs["sidecar_devices"] == DIST_WORLD
              and rs["live_devices"] == 2,
              f"[dist 4] rank {r['rank']}: the resume {rs}")
    e0 = el[0]
    log(f"[dist 4] BERT-base f32 {DIST_B} x {TRAIN_T}, Adam, dp 2 x tp 2 "
        f"(TP + SP) on {DIST_WORLD} gloo ranks; after 2 steps ranks 2 and 3 "
        f"(one dp replica) leave through the topology_change seam: "
        f"verdicts {[e['verdict'] for e in el]}, the transition (vote, "
        f"pre-flight, drain checkpoint, rendezvous, rebuild) "
        f"{e0['transition_s']:.1f} s on rank 0; the survivors on "
        f"{e0['mesh']} at generation {e0['generation']}, their parameters "
        f"and Adam state after resharding the pre-transition ones bit for "
        f"bit; losses " + ", ".join(f"{v:.6f}" for v in e0["losses"])
        + " (2 steps on 4 ranks, 2 on the survivors: falling), the "
        f"survivors' steps " + ", ".join(f"{t:.1f}" for t in e0["walls_ms"])
        + f" ms; each stores {sum(e0['stored_after'].values()) / 1e9:.3f} GB"
        f" (parameters, gradients, Adam); the pre-flight onto dp 2 with no "
        f"tp axis: {e0['aborted']}; the {DIST_WORLD}-rank drain "
        f"checkpoint (sidecar: {e0['resume']['sidecar_devices']} devices, "
        f"mesh {e0['resume']['mesh']}) resumed on "
        f"{e0['resume']['live_devices']} ranks in "
        f"{e0['resume']['seconds']:.1f} s, its parameters the saved ones "
        f"bit for bit")
    numbers.update(
        elastic=el,
        bert=dict(memory=mem, losses=res[0]["bert_losses"], no_mesh=want,
                  max_rel=rel, step_wall_ms=res[0]["bert_walls"],
                  median_wall_ms=wall, profiled_wall_ms=res[0][
                      "profiled_wall_ms"], device_busy_ms=busy,
                  idle_share=idle, idle_share_of_profiled_wall=idle_profiled,
                  param_rel=pr, sgd_update_rel=sr,
                  exchanges_sp=res[0]["exchanges_sp"],
                  tp_alone=tpa, amp_p01_loss=res[0]["amp_loss"],
                  dropout_keep=p["keep"]),
        ring=ring, pipe=res[0]["pipe"], moe=res[0]["moe"])
    for r in res:
        for key, n in r["counts"].items():
            totals[key] = totals.get(key, 0) + n
        for key, v in r["layouts"].items():
            for name, n in v.items():
                layouts.setdefault(key, {})
                layouts[key][name] = layouts[key].get(name, 0) + n
    t4 = time.perf_counter()
    numbers["seconds"] = dict(world_of_one=t1 - t0, nccl_probe=t2 - t1,
                              world=t3 - t2, checks=t4 - t3, total=t4 - t0)
    log(f"[dist] took {t4 - t0:.1f} s: the world of one {t1 - t0:.1f}, "
        f"NCCL's answer {t2 - t1:.1f}, the {DIST_WORLD}-rank world "
        f"{t3 - t2:.1f}, the references and checks {t4 - t3:.1f}; "
        f"launches {totals}")
    shutil.rmtree(work, ignore_errors=True)
    return numbers, totals, layouts


def dist_worker(rank, n, store, out, backend):
    """One rank of [dist]'s world on cuda:0 (this script with
    ``--dist-worker``): with "nccl" only a first all-reduce (the
    probe of NCCL's answer); with "gloo" parts (2)-(4), its results to
    ``out/rank<r>.pt``."""
    import os

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from incubator_mxnet_tpu_torch.parallel import dist

    dist.initialize(init_method=f"file://{store}", num_processes=n,
                    process_id=rank, backend=backend)
    try:
        if backend == "nccl":
            x = torch.ones(1, device=dev)
            torch.distributed.all_reduce(x)
            torch.cuda.synchronize()
            return 0
        reset_counts()
        res = {"rank": rank}
        _worker_bert(torch, dev, rank, res)
        _worker_ring(torch, dev, rank, n, res)
        _worker_pipe_moe(torch, dev, rank, n, res)
        _worker_elastic(torch, dev, rank, out, res)
        res["counts"] = read_counts()
        res["layouts"] = read_layout_counts()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        torch.distributed.barrier()
    finally:
        dist._shutdown()
    return 0


def _count_exchanges(torch, mesh, fn):
    """(fn(), {axis: [exchanges, buffer bytes, ms, wire bytes, {op:
    count}]}): the collectives ``fn`` made through the port's transport
    (`parallel.collectives`: every raw exchange reports to
    ``_STEP_CENSUS`` and runs in ``_exchange``), by the mesh axis of their
    group. Buffer bytes are each exchange's larger buffer, in or out (the
    measure of earlier runs); wire bytes what a ring algorithm moves out of
    each rank of n: an all-reduce 2 (n - 1) / n of its buffer, an
    all-gather, a reduce-scatter and an all-to-all (n - 1) / n. ms the
    host's time inside them (the card synchronized on entry and exit, so
    the time is the exchange's own, waits for the peers included)."""
    from incubator_mxnet_tpu_torch.parallel import collectives

    axes = {tuple(collectives._ranks(mesh.group(a))): a
            for a in mesh.shape if mesh.group(a) is not None}
    seen = {}

    def axis_of(group):
        return ("world" if group is None else axes.get(
            tuple(collectives._ranks(group)), "other"))

    def census(op, group, in_bytes, out_bytes, _carried):
        c = seen.setdefault(axis_of(group), [0, 0, 0.0, 0.0, {}])
        n = collectives._group_size(group)
        big = max(in_bytes, out_bytes)
        c[0] += 1
        c[1] += big
        c[3] += big * (n - 1) / n * (2 if op == "all-reduce" else 1)
        c[4][op] = c[4].get(op, 0) + 1

    real = collectives._exchange

    def timed(group, f, out, *ins):
        c = seen.setdefault(axis_of(group), [0, 0, 0.0, 0.0, {}])
        if out.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(group, f, out, *ins)
        finally:
            if out.is_cuda:
                torch.cuda.synchronize()
            c[2] += (time.perf_counter() - t0) * 1e3

    collectives._exchange, collectives._STEP_CENSUS = timed, census
    try:
        return fn(), seen
    finally:
        collectives._exchange, collectives._STEP_CENSUS = real, None


def _stored_digests(net):
    """(digest of the cut parameters' stored blocks, digest of the
    others): a dp replica's blocks are the same bits as its twin's, and
    the uncut parameters the same on every rank."""
    cut, rest = [], []
    for p in net.collect_params().values():
        (cut if p._placement is not None else rest).append(p._data._data)
    return _digest(cut), _digest(rest)


def _whole_params(net):
    """{name: whole tensor} (the blocks gathered: every rank calls it)."""
    return {n: p._whole_tensor() for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def _worker_bert(torch, dev, rank, res):
    from incubator_mxnet_tpu_torch import amp, npx
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import (bert_base,
                                                       tp_param_shardings)
    from incubator_mxnet_tpu_torch.optimizer import SGD, Adam
    from incubator_mxnet_tpu_torch.parallel import (DataParallel, _layout,
                                                    make_mesh)

    ce = SoftmaxCrossEntropyLoss()
    mesh = make_mesh({"dp": 2, "tp": 2})
    tokens, labels = _dist_batch(torch, dev, DIST_B)
    if rank == 0:
        # the no-mesh f32 step on the same weights and batch, which the
        # world is held against: its losses, its parameters after
        # DIST_STEPS Adam steps, and its update in one SGD step at lr 1
        # (the gradient); the other ranks wait in the first exchange
        net = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=0)
        dp = DataParallel(net, _mlm(ce), Adam(learning_rate=TRAIN_LR))
        mxrandom.seed(0)
        res["no_mesh_losses"] = [dp.step(tokens, labels).item()
                                 for _ in range(DIST_STEPS)]
        want = {n: p_.detach().clone() for n, p_ in net.named_parameters()}
        net = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=0)
        dp = DataParallel(net, _mlm(ce), SGD(learning_rate=1.0))
        before = {n: p_.detach().clone() for n, p_ in net.named_parameters()}
        dp.step(tokens, labels)
        sgd = {n: p_.detach() - before[n] for n, p_ in net.named_parameters()}
        del net, dp, before
        torch.cuda.empty_cache()

    def run(dropout, steps, walls=None, seq_axis="tp", exchanges=None,
            memory=None):
        """``exchanges``: a dict that takes the last step's exchanges;
        ``memory``: one that takes the rank's stored bytes and allocator
        peak (from just before the trainer was made)."""
        torch.cuda.synchronize()
        if memory is not None:
            torch.cuda.reset_peak_memory_stats(dev)
            memory["allocated_before"] = torch.cuda.memory_allocated(dev)
        net = bert_base(max_length=TRAIN_T, dropout=dropout, device=dev,
                        seed=0, seq_shard_axis=seq_axis)
        dp = DataParallel(net, _mlm(ce), Adam(learning_rate=TRAIN_LR),
                          mesh=mesh, param_shardings=tp_param_shardings(net))
        mxrandom.seed(0)
        losses, digests = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if exchanges is not None and i == steps - 1:
                loss, ex = _count_exchanges(
                    torch, mesh, lambda: dp.step(tokens, labels).item())
                exchanges.update(ex)
            else:
                loss = dp.step(tokens, labels).item()
            losses.append(loss)
            torch.cuda.synchronize()
            if walls is not None:
                walls.append((time.perf_counter() - t0) * 1e3)
            digests.append(_stored_digests(net))
        if memory is not None:
            torch.cuda.synchronize()
            memory["peak"] = torch.cuda.max_memory_allocated(dev)
            memory["allocated_after"] = torch.cuda.memory_allocated(dev)
            memory.update(dp.stored_bytes())
            whole = sum(math.prod(p.shape)
                        for p in net.collect_params().values()
                        if p.grad_req != "null") * 4
            memory["whole_params"] = whole
            memory["blocks"] = {
                n: tuple(p._data._data.shape)
                for n, p in net.collect_params().items()
                if p._placement is not None}
        return net, dp, losses, digests

    walls, res["exchanges_sp"], res["memory"] = [], {}, {}
    net, dp, res["bert_losses"], res["bert_digests"] = run(
        0.0, DIST_STEPS, walls, exchanges=res["exchanges_sp"],
        memory=res["memory"])
    res["bert_walls"] = walls
    res["tp_axis"] = dp._plan.tp_axis    # the compute split over tp
    whole = _whole_params(net)
    if rank == 0:
        # the parameters after the last step against the no-mesh step's
        # (every rank's are the same bits: the digests), as the tests hold
        # Adam's: where the first step's gradient is near zero (within
        # DIST_NEAR_ZERO of its leaf's largest; the no-mesh SGD step's
        # update), lr·sign(g) may flip and the element is held to the
        # steps' bound, 2 lr a step; elsewhere within GRAD_REL_TOL of the
        # leaf's largest magnitude
        far, near_abs, n_near = {}, 0.0, 0
        for name, prm in whole.items():
            w, g = want[name], sgd[name].abs()
            near = g <= DIST_NEAR_ZERO * g.max()
            d = (prm.detach() - w).abs()
            far[name] = (d[~near].max().item() / max(w.abs().max().item(),
                                                     1e-30)
                         if (~near).any() else 0.0)
            if near.any():
                near_abs = max(near_abs, d[near].max().item())
                n_near += int(near.sum())
        worst = max(far, key=far.get)
        res["param_rel"] = dict(max=far[worst], leaf=worst, leaves=len(far),
                                near_max_abs=near_abs, near_count=n_near,
                                near_bound=2 * TRAIN_LR * DIST_STEPS)
        del want
    del whole
    # one more step profiled on rank 0 (its device busy time), the same
    # steps unprofiled elsewhere
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        cen = profiled(torch, lambda: dp.step(tokens, labels), held=False)
        res["busy_ms"] = census_ms(cen) or None
    else:
        dp.step(tokens, labels)
    torch.cuda.synchronize()
    res["profiled_wall_ms"] = (time.perf_counter() - t0) * 1e3
    del net, dp
    torch.cuda.empty_cache()
    # one SGD step at lr 1 from the same weights: its update is the
    # reduced gradient, held against the no-mesh step's (a gradient-scale
    # fault, which Adam's update hides, shows here)
    net = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=0,
                    seq_shard_axis="tp")
    dp = DataParallel(net, _mlm(ce), SGD(learning_rate=1.0), mesh=mesh,
                      param_shardings=tp_param_shardings(net))
    before = {n: p_.clone() for n, p_ in _whole_params(net).items()}
    dp.step(tokens, labels)
    after = _whole_params(net)
    if rank == 0:
        errs = {}
        for name, prm in after.items():
            w = sgd[name]
            d = (prm.detach() - before[name] - w).abs().max().item()
            top = w.abs().max().item()
            # a leaf the loss does not reach (the NSP head) has no update
            errs[name] = d / top if top > 0 else d
        worst = max(errs, key=errs.get)
        res["sgd_rel"] = dict(max=errs[worst], leaf=worst, leaves=len(errs))
        del sgd
    del net, dp, before, after
    torch.cuda.empty_cache()
    # TP alone (no sequence parallelism) on the same world and batch: its
    # second step's wall and exchanges, against the TP + SP run's last
    ex, tp_walls = {}, []
    net, dp, tp_losses, _ = run(0.0, 2, tp_walls, seq_axis=None,
                                exchanges=ex)
    res["tp_alone"] = dict(wall_ms=tp_walls[-1], exchanges=ex,
                           first_loss=tp_losses[0])
    del net, dp
    torch.cuda.empty_cache()
    amp.init("bfloat16")
    try:
        net, dp, losses, digests = run(TRAIN_P, 1)
    finally:
        amp.deinit()
    res["amp_loss"], res["amp_digest"] = losses[0], digests[0]
    del net, dp
    torch.cuda.empty_cache()

    # the dropout contract: K5 at a replicated and a sequence-parallel
    # site of BERT-base's activation, a rank's rows of the batch
    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(C, device=dev))
            self.masks = []

        def forward(self, x):
            ones = torch.ones(x.shape[0], TRAIN_T, C, device=dev)
            rep = npx.dropout(ones, p=TRAIN_P)
            sp = _layout.seq_region(lambda a: npx.dropout(a, p=TRAIN_P),
                                    (ones,), "tp")
            self.masks.append((rep != 0, sp != 0))
            return (rep + sp) * self.w

    probe = Probe()
    dpp = DataParallel(probe, lambda o, y: o.mean(), SGD(learning_rate=0.0),
                       mesh=mesh)
    x = torch.zeros(DIST_B, 1, device=dev)
    for _ in range(2):
        dpp.step(x, x)
    (r0, s0), (r1, s1) = probe.masks
    half = TRAIN_T // 2
    cnt = r0.numel()
    res["probe"] = dict(
        digests=[(_digest([m[0]]), _digest([m[1]])) for m in probe.masks],
        keep=r0.float().mean().item(),
        keep_sigma=(TRAIN_P * (1 - TRAIN_P) / cnt) ** 0.5,
        halves_differ=bool((s0[:, :half] != s0[:, half:]).any()),
        fresh=bool((r0 != r1).any() and (s0 != s1).any()))
    del probe, dpp


def _worker_elastic(torch, dev, rank, out, res):
    """[dist 4]: BERT-base f32 over dp 2 x tp 2 (TP + SP, Adam) loses its
    second dp replica (ranks 2 and 3) through the ``topology_change``
    seam at a drained step boundary; the survivors reshard onto dp 1 x tp
    2, step on, show the pre-flight's abort once, and resume their drain
    checkpoint of the 4-rank run on their 2 ranks. The last part of the
    worker: the leavers wait for the others at its closing barrier."""
    import os

    from incubator_mxnet_tpu_torch import preemption
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.fault import elastic, injection
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import (bert_base,
                                                       tp_param_shardings)
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import (DataParallel, dist,
                                                    make_mesh)

    ce = SoftmaxCrossEntropyLoss()
    tokens, labels = _dist_batch(torch, dev, DIST_B)
    net = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=0,
                    seq_shard_axis="tp")
    dp = DataParallel(net, _mlm(ce), Adam(learning_rate=TRAIN_LR),
                      mesh=make_mesh({"dp": 2, "tp": 2}),
                      param_shardings=tp_param_shardings(net))
    mxrandom.seed(0)
    prefix = os.path.join(out, f"elastic{rank}")
    # the survivors' drain checkpoint (a tp pair saves together)
    ck = (preemption.TrainingCheckpointer(
        prefix, net, every_n=10 ** 9, register_signal=False,
        layout_fn=lambda: elastic.checkpoint_layout(dp)) if rank < 2
        else None)
    ctl = elastic.ElasticController(trainer=dp, checkpointer=ck,
                                    drain_s=DIST_TIMEOUT_S)
    losses = [dp.step(tokens, labels).item() for _ in range(2)]
    before = {n: t.clone() for n, t in _whole_params(net).items()}
    states = [dp._whole_state(i, st) for i, st in enumerate(dp.opt_states)]
    if rank >= 2:
        injection.configure_injection(f"topology_change@{rank}:1.0:0:1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdict = ctl.poll()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    injection.clear_injection()
    info = res["elastic"] = dict(verdict=verdict, transition_s=seconds,
                                 generation=dist.generation())
    if verdict == "leave":
        del net, dp, before, states
        torch.cuda.empty_cache()
        return
    info["mesh"] = dict(dp.mesh.shape)
    after = _whole_params(net)
    info["params_bits"] = all(torch.equal(before[k], after[k])
                              for k in before)
    moved = [dp._whole_state(i, st) for i, st in enumerate(dp.opt_states)]
    info["state_bits"] = all(
        torch.equal(a, b) for x, y in zip(states, moved)
        for a, b in zip(x if isinstance(x, list) else [x],
                        y if isinstance(y, list) else [y])
        if isinstance(a, torch.Tensor))
    del after, moved, states
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(dp.step(tokens, labels).item())
        torch.cuda.synchronize()
        info.setdefault("walls_ms", []).append(
            (time.perf_counter() - t1) * 1e3)
    info["losses"] = losses
    info["stored_after"] = dp.stored_bytes()
    # the pre-flight of a layout with no tp axis: the cut parameters
    # would be replicated on every rank (SC001): aborted, nothing commits
    gen = dist.generation()
    try:
        ctl._preflight(make_mesh({"dp": 2}, devices=[0, 1]))
        info["aborted"] = None
    except elastic.ElasticTransitionAborted as e:
        info["aborted"] = dict(rules=sorted({f.rule for f in e.findings}),
                               findings=len(e.findings),
                               first=str(e)[:240],
                               generation_kept=dist.generation() == gen)
    # the 4-rank drain checkpoint resumed on the 2 survivors
    side = preemption.load_layout(ck._mgr.latest())
    net_b = bert_base(max_length=TRAIN_T, dropout=0.0, device=dev, seed=1,
                      seq_shard_axis="tp")
    t1 = time.perf_counter()
    step = preemption.TrainingCheckpointer(
        prefix, net_b, register_signal=False).resume()
    info["resume"] = dict(
        step=step, seconds=time.perf_counter() - t1,
        sidecar_devices=side["device_count"], live_devices=dist.world_size(),
        mesh=side["mesh"],
        bits=all(torch.equal(before[k], v)
                 for k, v in _whole_params(net_b).items()))
    del net, dp, net_b, before
    torch.cuda.empty_cache()


def _worker_ring(torch, dev, rank, n, res):
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.flash_attention")
    from incubator_mxnet_tpu_torch.parallel import (make_mesh, mesh_scope,
                                                    ring_attention)

    mesh = make_mesh({"sp": n})
    q, k, v, do = _dist_ring_inputs(torch, dev)
    c = q.shape[2] // n
    blocks = [x[:, :, rank * c:(rank + 1) * c].contiguous()
              for x in (q, k, v, do)]
    del q, k, v, do
    for causal in (False, True):
        qb, kb, vb = (x.clone().requires_grad_() for x in blocks[:3])
        f0, b0 = fa.launches, fa.bwd_launches
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        with mesh_scope(mesh):
            torch.distributed.barrier()
            start.record()
            o = ring_attention(qb, kb, vb, "sp", causal=causal)
            end.record()
            end.synchronize()
            o.backward(blocks[3])
        torch.cuda.synchronize()
        res[f"ring_ms_{causal}"] = start.elapsed_time(end)
        res[f"ring_hops_{causal}"] = (fa.launches - f0, fa.bwd_launches - b0)
        res[f"ring_{causal}"] = [t.detach().cpu() for t in
                                 (o, qb.grad, kb.grad, vb.grad)]


def _worker_pipe_moe(torch, dev, rank, n, res):
    from incubator_mxnet_tpu_torch.optimizer import SGD
    from incubator_mxnet_tpu_torch.parallel import (collectives, make_mesh,
                                                    mesh_scope,
                                                    shard_train_step)
    from incubator_mxnet_tpu_torch.parallel.moe import (
        moe_dispatch_combine, moe_ffn_apply)
    from incubator_mxnet_tpu_torch.parallel.pipeline import (
        PipelineParallel, pipeline_apply)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    # GPipe over pp = n: a width-768 dense stage, 4 microbatches
    p = DIST_PIPE
    g = torch.Generator().manual_seed(2)
    w = (torch.randn(n, p["width"], p["width"], generator=g)
         / p["width"] ** 0.5).to(dev)
    b = torch.zeros(n, p["width"], device=dev)
    x = torch.randn(p["micro"], p["rows"], p["width"], generator=g).to(dev)
    y = torch.randn(p["micro"], p["rows"], p["width"], generator=g).to(dev)

    def stage(prm, act):
        return torch.tanh(act @ prm["w"] + prm["b"])

    pp = make_mesh({"pp": n})
    f = shard_train_step(
        lambda ww, bb, xx: pipeline_apply(stage, {"w": ww[0], "b": bb[0]},
                                          xx, "pp")[None],
        pp, in_specs=(("pp",), ("pp",), ()), out_specs=("pp",))
    out = f(w, b, x)[-1]
    ref = x
    for s in range(n):
        ref = stage({"w": w[s], "b": b[s]}, ref)
    trainer = PipelineParallel(stage, {"w": w, "b": b},
                               lambda o, yy: ((o - yy) ** 2).mean(),
                               SGD(learning_rate=p["lr"]), pp)
    losses = [trainer.step(x, y).item() for _ in range(p["steps"])]
    res["pipe"] = dict(
        what=f"GPipe over pp = {n}: a {p['width']}-wide tanh dense stage a "
             f"rank, {p['micro']} microbatches of {p['rows']} rows, f32",
        rel=rel(out, ref), losses=losses)
    # top-2 MoE over ep = n: BERT-base's FFN widths, 4 experts
    m = DIST_MOE
    g = torch.Generator().manual_seed(3)
    D, Hd, E = m["units"], m["hidden"], m["experts"]
    prm = {"gw": torch.randn(D, E, generator=g) / D ** 0.5,
           "w1": torch.randn(E, D, Hd, generator=g) / D ** 0.5,
           "b1": torch.zeros(E, Hd),
           "w2": torch.randn(E, Hd, D, generator=g) / Hd ** 0.5,
           "b2": torch.zeros(E, D)}
    prm = {k: t.to(dev) for k, t in prm.items()}
    xs = torch.randn(n * m["tokens"], D, generator=g).to(dev)
    ys = torch.randn(n * m["tokens"], D, generator=g).to(dev)
    T = m["tokens"]
    xb, yb = xs[rank * T:(rank + 1) * T], ys[rank * T:(rank + 1) * T]
    el = E // n
    mine = {k: (v[rank * el:(rank + 1) * el] if k != "gw" else v)
            for k, v in prm.items()}
    ep = make_mesh({"ep": n})

    def layer(q, axis):
        return moe_dispatch_combine(
            xb, xb @ q["gw"], moe_ffn_apply(q["w1"], q["b1"], q["w2"],
                                            q["b2"]),
            capacity_factor=m["cf"], axis_name=axis, top_k=2)

    with mesh_scope(ep):
        sharded, _ = layer(mine, "ep")
    local, _ = layer(prm, None)
    losses = []
    with mesh_scope(ep):
        for _ in range(m["steps"]):
            q = {k: v.clone().requires_grad_() for k, v in mine.items()}
            o, aux = layer(q, "ep")
            loss = ((o - yb) ** 2).mean() + 0.01 * aux
            (loss / n).backward()
            losses.append(collectives.all_reduce(loss.detach(), "ep",
                                                 "mean").item())
            gr = {k: v.grad for k, v in q.items()}
            gr["gw"] = collectives.all_reduce(gr["gw"], "ep")
            mine = {k: mine[k] - m["lr"] * gr[k] for k in mine}
    res["moe"] = dict(
        what=f"top-2 MoE over ep = {n}: {E} experts {D} -> {Hd} -> {D}, "
             f"capacity factor {m['cf']}, {T} tokens a rank, f32",
        rel=rel(sharded, local), losses=losses)


# ---------------------------------------------------------------------------
# [shard]: sharded serving (serve.sharded) at full width, and [fleet]: the
# fleet plane (telemetry.fleet) over a gloo world
# ---------------------------------------------------------------------------

# [shard]: GPT-2 small (gpt2_small: 768 units, 12 heads, 12 layers, vocab
# 50257), seeded weights (seed 0), f32, the engine of `phase_serve_engine`
# (8 slots of 256 tokens) on the prompts and budgets of trace A's first
# SHARD_REQUESTS requests, all submitted at once. (1) an NCCL world of one, mesh tp=1: the tokens bit for bit the
# unsharded SlotDecoder's, the decode step one replayed graph, the program
# count flat after the warm-up. (2) SHARD_TP ranks of a SHARD_WORLD-rank
# gloo world (the card shared) behind the front, rank 0: the same requests
# against the unsharded engine on rank 0; the first decode step's logits
# within SHARD_LOGIT_ATOL, each token stream equal but where the tp
# partial sums round a near-tie the other way (the unsharded top-2 gap
# there under SHARD_TIE_GAP, at most one stream). (3) bench.py:1378
# (`bench_gpt_serve_sharded`) as written (its warm-up asks 3 tokens a
# request, not 2: a step's graph is captured at its second call), on every
# rank: tp 4 x 2 replicas behind the gateway against one unsharded
# replica. (4) one hot_swap
# mid-stream on (3)'s gateway.
SHARD_WORLD = 8
SHARD_TP = 4
# trace A's first requests, (1) and (2) alike: a tp 4 decode step through
# gloo's host copies takes ~0.3 s on the shared card (PERF.md §6), so the whole
# trace would hold the script ~90 s
SHARD_REQUESTS = 8
SHARD_LOGIT_ATOL = 1e-4
SHARD_TIE_GAP = 1e-3
SHARD_BENCH = dict(requests=16, max_slots=4, prompt_max=40, new_max=20,
                   tp=4, n_replicas=2, seed=0)
SHARD_TIMEOUT_S = 600
# [fleet]: FLEET_WORLD gloo ranks; rank 1 slowed by collective_delay (120
# ms, `fault.injection`) and slow local steps; rank FLEET_CRASH_RANK
# raises at the end; bench.py:1677's off/armed pair (n 256, 40 iterations
# after 5, 2 interleaved rounds, the minimum of each leg)
FLEET_WORLD = 4
FLEET_CRASH_RANK = 3
FLEET_OVERHEAD = dict(n=256, iters=40, warmup=5, rounds=2)
FLEET_TIMEOUT_S = 240
# the card's pinned host-copy rate (the gloo transport's peak): bytes a copy
HOST_COPY_BYTES = 256 * 2**20


def _worker_spawn(kind, n, store, out, timeout, env=None):
    """``n`` worker processes of this script (``--<kind>-worker``) on the
    card: (return codes, outputs)."""
    import os

    envs = dict(os.environ, **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-worker",
         str(r), str(n), store, out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=envs) for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                o, _ = p.communicate(timeout=max(1.0, deadline -
                                                 time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                o, _ = p.communicate()
                o = (o or "") + "\n(killed at the time limit)"
            outs.append(o or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _worker_join(torch, rank, n, store):
    """A worker's card and gloo world."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from incubator_mxnet_tpu_torch.parallel import dist

    dist.initialize(init_method=f"file://{store}", num_processes=n,
                    process_id=rank, backend="gloo")
    return dev, dist


def _shard_trace(onp):
    """The prompts and budgets of trace A's first SHARD_REQUESTS."""
    prompts, budgets, _ = _serve_trace_a(onp)
    return prompts[:SHARD_REQUESTS], budgets[:SHARD_REQUESTS]


def _shard_serve(eng, prompts, budgets, warm=True):
    """The warm-up of `_serve_warmup` (every chunk bucket, every step
    family) through a Scheduler over ``eng``, then every request at once,
    greedy. Returns (tokens a request, (programs after the warm-up, after
    the requests), seconds of the requests)."""
    import numpy as onp
    import torch

    from incubator_mxnet_tpu_torch import serve

    sched = serve.Scheduler(eng, max_queue=4 * len(prompts), seed=0)

    def run(ps, bs):
        reqs = [sched.submit(p, b) for p, b in zip(ps, bs)]
        while not all(r.done for r in reqs):
            sched.step()
        return [[int(t) for t in r.result()] for r in reqs]

    if warm:
        for w in (onp.resize(prompts[0], 16), onp.resize(prompts[0], 48),
                  onp.resize(prompts[1], 48)):
            run([w], [2])
    torch.cuda.synchronize()
    warm_count = eng.xla_program_count()
    t0 = time.perf_counter()
    toks = run(prompts, budgets)
    torch.cuda.synchronize()
    return toks, (warm_count, eng.xla_program_count()), \
        time.perf_counter() - t0


def _first_decode_logits(eng):
    """Keep the first decode step's active rows and their logits (the
    engine's instance methods wrapped)."""
    first = {}
    step, sample = eng.decode_step, eng._sample_slots

    def decode_step(last_tok, pos, active, key, temperature):
        arm = "active" not in first
        if arm:
            first["active"] = [bool(a) for a in active]
            first["armed"] = True
        try:
            return step(last_tok, pos, active, key, temperature)
        finally:
            first["armed"] = False

    def sample_slots(logits, key, temperature):
        if first.get("armed"):
            first["logits"] = logits.detach().float().cpu()
        return sample(logits, key, temperature)

    eng.decode_step, eng._sample_slots = decode_step, sample_slots
    return first


def _shard_world_of_one(torch, dev, store):
    """[shard] (1): returns (numbers, K4 launches, by layout)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small
    from incubator_mxnet_tpu_torch.parallel import dist
    from incubator_mxnet_tpu_torch.serve.sharded import (ShardedSlotDecoder,
                                                         serve_mesh)

    dist.initialize(init_method=f"file://{store}", num_processes=1,
                    process_id=0, backend="nccl")
    try:
        model = gpt2_small(device=dev, seed=0).eval()
        prompts, budgets = _shard_trace(onp)
        base = serve.SlotDecoder(model, max_slots=SERVE_SLOTS,
                                 max_len=SERVE_MAX_LEN)
        want, base_counts, base_s = _shard_serve(base, prompts, budgets)
        base.release()
        del base
        reset_counts()
        sh = ShardedSlotDecoder(model, mesh=serve_mesh("tp=1"),
                                max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        got, counts, sh_s = _shard_serve(sh, prompts, budgets)
        k4, layouts = read_counts()["K4"], read_layout_counts()["K4"]
        local = sh._local
        captured = dict(local.captures_by_step)
        sh.release()
        del sh, local, model
    finally:
        dist._shutdown()
    torch.cuda.empty_cache()
    check(got == want, "[shard 1] the tp=1 engine's greedy tokens differ "
          "from the unsharded engine's: requests "
          f"{[i for i, (a, b) in enumerate(zip(got, want)) if a != b]}")
    check(captured["decode"] == 1, f"[shard 1] the decode step was "
          f"captured {captured['decode']} times; one replayed graph "
          "expected")
    check(counts[0] == counts[1] and base_counts[0] == base_counts[1],
          f"[shard 1] programs after the warm-up -> after the requests: "
          f"{counts} (sharded), {base_counts} (unsharded)")
    check(k4 > 0, "[shard 1] no K4 launch through the sharded engine")
    tokens = sum(len(t) for t in got)
    log(f"[shard 1] NCCL world of one, mesh tp=1, gpt2_small f32, trace A's "
        f"first {len(prompts)} requests at once ({tokens} tokens): greedy tokens "
        f"bit for bit the unsharded SlotDecoder's; the decode step captured "
        f"once and replayed (captures {captured}); programs {counts[0]} "
        f"after the warm-up, {counts[1]} after the requests (unsharded "
        f"{base_counts}); {tokens / sh_s:.1f} tokens/s against the "
        f"unsharded engine's {tokens / base_s:.1f}; K4 launched {k4} times "
        "through the wrapper (eager and capturing steps, prefills)")
    return (dict(tokens=tokens, bit_for_bit=True, captures=captured,
                 programs=counts, unsharded_programs=base_counts,
                 tokens_s=tokens / sh_s, unsharded_tokens_s=tokens / base_s,
                 k4_launches=k4), k4, layouts)


def _instrument_shards(torch, stats):
    """Wrap the shards' record execution to keep, per shard of this rank
    (in the order they were made): its mesh, the ops it ran, its K4
    launches, and its stored weight and pool bytes counted from its
    tensors."""
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln
    from incubator_mxnet_tpu_torch.serve import sharded

    orig = sharded._Shard._execute

    def execute(self, op, args, table, name):
        key = self.__dict__.get("_smoke_key")
        if key is None:
            key = self._smoke_key = len(stats)
            stats.append({"mesh": list(self._cfg["ranks"]), "ops": {},
                          "k4": 0, "params_bytes": 0, "pool_bytes": 0})
        s = stats[key]
        k0 = ln.launches
        out = orig(self, op, args, table, name)
        s["ops"][op] = s["ops"].get(op, 0) + 1
        s["k4"] += ln.launches - k0
        s["params_bytes"] = sum(t.numel() * t.element_size()
                                for t in self._param_arrays())
        s["pool_bytes"] = max(s["pool_bytes"], self.cache_bytes)
        return out

    sharded._Shard._execute = execute


def _shard_near_tie(torch, model, prompt, toks, p):
    """The unsharded model's gap between its two largest logits after
    ``prompt`` and ``toks[:p]`` (a full forward on the card)."""
    import numpy as onp

    seq = onp.concatenate([prompt, onp.asarray(toks[:p], onp.int32)])
    with torch.no_grad():
        out = model(torch.from_numpy(seq.astype(onp.int64))[None].to(
            model.device))
    out = getattr(out, "_data", out)
    top = torch.topk(out[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _shard_front_tp(torch, dev, res):
    """[shard] (2) on the front: the unsharded engine, then tp SHARD_TP."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_small
    from incubator_mxnet_tpu_torch.parallel import collectives
    from incubator_mxnet_tpu_torch.serve.sharded import (ShardedSlotDecoder,
                                                         serve_mesh)

    model = gpt2_small(device=dev, seed=0).eval()
    prompts, budgets = _shard_trace(onp)
    base = serve.SlotDecoder(model, max_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN)
    base_first = _first_decode_logits(base)
    base_walls = []
    base.decode_step = _timed(base.decode_step, base_walls)
    want, base_counts, base_s = _shard_serve(base, prompts, budgets)
    whole_params = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    whole_pool = base.cache_bytes
    base.release()
    del base

    sh = ShardedSlotDecoder(model, mesh=serve_mesh({"tp": SHARD_TP}),
                            max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    first = _first_decode_logits(sh._local)
    walls, ex_s, census = [], [], []
    step = sh.decode_step
    exchange, note = collectives._exchange, collectives._STEP_CENSUS
    inside = {"on": False, "s": 0.0, "ops": {}}

    def timed_exchange(group, fn, out, *ins):
        if not inside["on"]:
            return exchange(group, fn, out, *ins)
        t0 = time.perf_counter()
        try:
            return exchange(group, fn, out, *ins)
        finally:
            inside["s"] += time.perf_counter() - t0

    def count(op, group, in_bytes, out_bytes, operands):  # noqa: ARG001
        if inside["on"]:
            rec = inside["ops"].setdefault(op, [0, 0])
            rec[0] += 1
            rec[1] += out_bytes

    def decode_step(*args):
        inside.update(on=True, s=0.0, ops={})
        t0 = time.perf_counter()
        try:
            return step(*args)
        finally:
            walls.append(time.perf_counter() - t0)
            inside["on"] = False
            ex_s.append(inside["s"])
            census.append({k: tuple(v) for k, v in inside["ops"].items()})

    collectives._exchange, collectives._STEP_CENSUS = timed_exchange, count
    sh.decode_step = decode_step
    try:
        got, counts, sh_s = _shard_serve(sh, prompts, budgets)
    finally:
        collectives._exchange, collectives._STEP_CENSUS = exchange, note
    local_pool = sh._local.cache_bytes
    sh.release()
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    ties = []
    for i in diff:
        p = next((j for j, (a, b) in enumerate(zip(got[i], want[i]))
                  if a != b), min(len(got[i]), len(want[i])))
        ties.append({"request": i, "position": p,
                     "unsharded_top2_gap": _shard_near_tie(
                         torch, model, prompts[i], want[i], p)})
    rows = [s for s, a in enumerate(base_first["active"]) if a]
    err = float((first["logits"][rows] - base_first["logits"][rows]).abs()
                .max()) if rows and first["active"] == base_first["active"] \
        else None
    # the steady state: every slot decoding (the first steps fill them)
    full = [w for w, c in zip(walls, census) if c][len(walls) // 4:]
    shares = [e / w for w, e, c in zip(walls, ex_s, census) if c
              ][len(walls) // 4:]
    res["tp"] = dict(
        tokens=sum(len(t) for t in got), unsharded_tokens=want,
        sharded_tokens=got, differ=ties, first_logits_max_abs_err=err,
        first_active=first["active"], programs=counts,
        unsharded_programs=base_counts, tokens_s=sum(map(len, got)) / sh_s,
        unsharded_tokens_s=sum(map(len, want)) / base_s,
        decode_wall_ms=float(onp.median(full)) * 1e3,
        exchange_share=float(onp.median(shares)),
        unsharded_decode_wall_ms=float(onp.median(
            base_walls[len(base_walls) // 4:])) * 1e3,
        census_a_step=census[len(census) // 2],
        whole_params_bytes=whole_params, whole_pool_bytes=whole_pool,
        front_pool_bytes=local_pool)


def _shard_front_bench(torch, dev, res):
    """[shard] (3) bench.py:1378 as written on the port, and (4) one
    hot_swap mid-stream on its sharded gateway."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.gpt import GPTModel

    b = SHARD_BENCH
    vocab, max_len = 8000, 80
    net = GPTModel(vocab, 256, 1024, 4, 4, max_len, 0.0, device=dev,
                   seed=b["seed"]).eval()
    rng = onp.random.RandomState(b["seed"])
    prompts = [rng.randint(0, vocab, (int(rng.randint(8, b["prompt_max"])),))
               .astype(onp.int32) for _ in range(b["requests"])]
    budgets = [int(rng.randint(b["new_max"] // 2, b["new_max"]))
               for _ in range(b["requests"])]

    def run(mesh, replicas, swap=None):
        reg = serve.ModelRegistry()
        reg.add("m", net, replicas=replicas, mesh=mesh,
                max_slots=b["max_slots"], max_len=max_len, n_pages=32)
        gw = serve.Gateway(reg, seed=b["seed"])
        try:
            # the bench's warm-up, 3 tokens a request where it asks 2:
            # the port captures a step's graph at its second call (two
            # decode steps), where XLA compiles at the first
            wrng = onp.random.RandomState(b["seed"] + 1)
            for rep in gw._models["m"].replicas:
                warm = [rep.sched.submit(
                    wrng.randint(0, vocab, (n,)).astype(onp.int32), 3,
                    temperature=1.0) for n in (12, 24, 40)]
                for _ in range(2000):
                    rep.sched.step()
                    if all(w.done for w in warm):
                        break
                check(all(w.done for w in warm),
                      "[shard 3] replica warmup did not complete")
            programs_warm = gw.xla_program_counts()
            t0 = time.perf_counter()
            reqs = [gw.submit("m", p, n) for p, n in zip(prompts, budgets)]
            while not all(r.done for r in reqs):
                gw.step()
                check(time.perf_counter() - t0 < 600,
                      "[shard 3] sharded serve replay timed out")
            t_total = time.perf_counter() - t0
            check(gw.xla_program_counts() == programs_warm,
                  f"[shard 3] steady-state build during the replay: "
                  f"{programs_warm} -> {gw.xla_program_counts()}")
            total_new = sum(len(r.result()) for r in reqs)  # raises on err
            ttfts = [r.ttft for r in reqs]
            check(total_new > 0 and all(t is not None for t in ttfts)
                  and t_total > 0, f"[shard 3] degenerate run: tokens="
                  f"{total_new}")
            out = {"tokens_s": total_new / t_total,
                   "p50_ms": float(onp.percentile(ttfts, 50)) * 1e3,
                   "p99_ms": float(onp.percentile(ttfts, 99)) * 1e3,
                   "replicas_used": len({r.replica for r in reqs})}
            check(replicas == 1 or out["replicas_used"] == replicas,
                  f"[shard 3] the router starved a replica: "
                  f"{out['replicas_used']}/{replicas} saw traffic")
            if mesh is not None:
                eng = gw._models["m"].replicas[0].slots
                report = eng.shardcheck_report()
                for fam in ("prefill", "decode"):
                    check(not report[fam].findings,
                          f"[shard 3] dirty shardcheck on sharded {fam}: "
                          f"{[(f.rule, f.message) for f in report[fam].findings]}")
                step_bytes = sum(rec["bytes"] for rec in
                                 report["decode"].collectives.values())
                out["decode_collectives"] = report["decode"].collectives
                out["collective_bytes_per_token"] = step_bytes / b[
                    "max_slots"]
                out["kv_bytes_total"] = eng.cache_bytes
                out["kv_bytes_per_device"] = eng._local.cache_bytes
            if swap is not None:
                out["swap"] = swap(gw)
            return out
        finally:
            gw.shutdown(drain=False)

    def swap(gw):
        """(4): weights replaced mid-stream, one replica at a time."""
        inflight = [gw.submit("m", p, n) for p, n in
                    zip(prompts[:8], budgets[:8])]
        gw.step()
        r = onp.random.RandomState(5)
        for p in net.collect_params().values():
            if len(p.shape) >= 2:
                p.set_data(torch.from_numpy(
                    r.normal(0, 0.02, p.shape).astype("float32")).to(dev))
        first = gw.hot_swap("m")
        while not all(q.done for q in inflight):
            gw.step()
        results = [q.result() for q in inflight]    # raises on a failure
        return {"first": first, "second": gw.hot_swap("m"),
                "tokens": sum(map(len, results)),
                "all_answered": all(results)}

    base = run(None, 1)
    shard = run(f"tp={b['tp']}", b["n_replicas"], swap=swap)
    shard["1dev_tokens_s"] = base["tokens_s"]
    shard["vs_1dev"] = shard["tokens_s"] / base["tokens_s"]
    shard["1dev"] = base
    res["bench"] = shard


def shard_worker(rank, n, store, out):
    """One rank of [shard]'s gloo world on cuda:0 (this script with
    ``--shard-worker``): rank 0 is the front and runs (2)-(4); the others
    serve their shards. Each saves ``out/rank<r>.pt``: its shards' ops,
    K4 launches (the counter and the launch log) and stored bytes."""
    import os

    import torch

    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.serve import sharded

    dev, dist = _worker_join(torch, rank, n, store)
    stats = []
    _instrument_shards(torch, stats)
    res = {"rank": rank}
    try:
        reset_counts()
        _build.LAUNCH_LOG = log = []
        if rank == 0:
            try:
                t0 = time.perf_counter()
                _shard_front_tp(torch, dev, res)
                t1 = time.perf_counter()
                _shard_front_bench(torch, dev, res)
                res["seconds"] = dict(tp=t1 - t0,
                                      bench=time.perf_counter() - t1)
            finally:
                sharded._stop_shards()
        else:
            sharded._serve_shards()
        _build.LAUNCH_LOG = None
        res["counts"] = read_counts()
        res["layouts"] = read_layout_counts()
        res["k4_logged"] = sum(1 for e in log if "ln_fwd" in str(e[0]))
        res["shards"] = stats
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        torch.distributed.barrier()
    finally:
        _build.LAUNCH_LOG = None
        dist._shutdown()
    return 0


def phase_shard(torch, dev):
    """[shard] (see the constants above); returns (numbers, launches,
    launches by layout)."""
    import os
    import shutil

    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "shard_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    one, k4_one, lay_one = _shard_world_of_one(
        torch, dev, os.path.join(work, "store_one"))
    t1 = time.perf_counter()
    rcs, outs = _worker_spawn("shard", SHARD_WORLD,
                              os.path.join(work, "store"), work,
                              SHARD_TIMEOUT_S)
    check(not any(rcs), "[shard] workers failed " + str(rcs) + ":\n" +
          "\n".join(f"--- rank {r} ---\n{o[-3000:]}"
                    for r, (rc, o) in enumerate(zip(rcs, outs)) if rc))
    t2 = time.perf_counter()
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(SHARD_WORLD)]
    tp = res[0]["tp"]
    # (2) the logits, the streams, the near-ties
    check(tp["first_logits_max_abs_err"] is not None
          and tp["first_logits_max_abs_err"] <= SHARD_LOGIT_ATOL,
          f"[shard 2] the first decode step's logits at tp {SHARD_TP}: max "
          f"abs error {tp['first_logits_max_abs_err']} against the "
          f"unsharded engine's (tol {SHARD_LOGIT_ATOL:g}; active rows "
          f"{tp['first_active']})")
    check(len(tp["differ"]) <= 1 and all(
        d["unsharded_top2_gap"] < SHARD_TIE_GAP for d in tp["differ"]),
        f"[shard 2] token streams differ beyond a near-tie: {tp['differ']}")
    check(tp["programs"][0] == tp["programs"][1],
          f"[shard 2] programs {tp['programs']}: a build after the warm-up")
    census = tp["census_a_step"]
    check(set(census) == {"all-reduce"}
          and census["all-reduce"][0] == 3 * LAYERS,
          f"[shard 2] a decode step's exchanges {census}; {3 * LAYERS} "
          "all-reduces and nothing else expected")
    # the ranks' stores and K4 launches
    mesh_tp = list(range(SHARD_TP))
    ranks_tp = [next(s for s in r["shards"] if s["mesh"] == mesh_tp)
                for r in res[:SHARD_TP]]
    for r, s in zip(res, ranks_tp):
        ratio = s["params_bytes"] / tp["whole_params_bytes"]
        pool = s["pool_bytes"] / tp["whole_pool_bytes"]
        check(abs(pool - 1 / SHARD_TP) < 1e-9 and ratio < 1,
              f"[shard 2] rank {r['rank']} stores {s['params_bytes']} "
              f"weight bytes ({ratio:.4f}) and {s['pool_bytes']} pool bytes "
              f"({pool:.4f} of the unsharded engine's)")
        log(f"[shard 2] rank {r['rank']} stores, counted from its tensors: "
            f"weights {s['params_bytes'] / 1e6:.1f} MB ({ratio:.4f} of the "
            f"whole model's {tp['whole_params_bytes'] / 1e6:.1f} MB), K/V "
            f"pools {s['pool_bytes'] / 1e6:.1f} MB ({pool:.4f} of the "
            f"unsharded engine's {tp['whole_pool_bytes'] / 1e6:.1f} MB); "
            f"ran {s['ops']}; K4 launched {s['k4']} times")
    k4s = [s["k4"] for s in ranks_tp]
    passes = ranks_tp[0]["ops"].get("prefill_chunk_step", 0) + \
        ranks_tp[0]["ops"].get("decode_step", 0)
    check(len(set(k4s)) == 1 and k4s[0] == passes * SERVE_K4_PER_PASS,
          f"[shard 2] K4 launches by rank {k4s}; {passes} passes x "
          f"{SERVE_K4_PER_PASS} on every rank expected")
    logged = [r["k4_logged"] for r in res]
    check(all(n >= k for n, k in zip(logged, k4s)) and all(logged),
          f"[shard] K4 entries in the ranks' launch logs {logged}")
    ties = ", ".join(f"request {d['request']} at token {d['position']} "
                     f"(unsharded top-2 gap {d['unsharded_top2_gap']:.3e})"
                     for d in tp["differ"]) or "none"
    log(f"[shard 2] {SHARD_TP} gloo ranks sharing the card, tp "
        f"{SHARD_TP} behind the front (rank 0), gpt2_small f32, trace A's "
        f"first {len(tp['sharded_tokens'])} requests at once: the first decode "
        f"step's logits within {tp['first_logits_max_abs_err']:.3e} of the "
        f"unsharded engine's; streams that differ: {ties}; programs "
        f"{tp['programs']}; a decode step made {census} (all-reduces, "
        f"bytes); its median wall {tp['decode_wall_ms']:.3f} ms, "
        f"{tp['exchange_share']:.4f} of it inside the exchanges, against "
        f"the unsharded replay's {tp['unsharded_decode_wall_ms']:.4f} ms "
        f"in the same process; {tp['tokens_s']:.1f} tokens/s against "
        f"{tp['unsharded_tokens_s']:.1f}; K4 launches on every rank "
        f"{k4s} (the launch logs: {logged[:SHARD_TP]})")
    bench = res[0]["bench"]
    swap = bench.pop("swap")
    check(swap["first"] == {"m#0": True, "m#1": True}
          and swap["second"] == {"m#0": False, "m#1": False}
          and swap["all_answered"],
          f"[shard 4] the hot swap: {swap}")
    for rep in (0, 1):
        mesh = list(range(rep * SHARD_BENCH["tp"],
                          (rep + 1) * SHARD_BENCH["tp"]))
        k4 = [next(s["k4"] for s in r["shards"] if s["mesh"] == mesh)
              for r in res[mesh[0]:mesh[-1] + 1]]
        check(len(set(k4)) == 1 and k4[0] > 0,
              f"[shard 3] replica {rep}'s ranks {mesh} launched K4 {k4}")
    log(f"[shard 3] bench.py:1378 on the port, tp {SHARD_BENCH['tp']} x "
        f"{SHARD_BENCH['n_replicas']} replicas behind the gateway "
        f"({SHARD_WORLD} gloo ranks): {bench['tokens_s']:.1f} tokens/s, "
        f"TTFT p50 {bench['p50_ms']:.1f} ms p99 {bench['p99_ms']:.1f} ms, "
        f"replicas_used {bench['replicas_used']}, "
        f"collective_bytes_per_token "
        f"{bench['collective_bytes_per_token']:.1f}, kv_bytes_per_device "
        f"{bench['kv_bytes_per_device']} of kv_bytes_total "
        f"{bench['kv_bytes_total']}, vs_1dev {bench['vs_1dev']:.4f} (one "
        f"unsharded replica: {bench['1dev_tokens_s']:.1f} tokens/s); the "
        f"decode census {bench['decode_collectives']}; shardcheck clean")
    log(f"[shard 4] hot_swap mid-stream: {swap['first']} then "
        f"{swap['second']}; {swap['tokens']} tokens, no failed request")
    totals, layouts = {"K4": k4_one}, {"K4": dict(lay_one)}
    for r in res:
        for key, n in r["counts"].items():
            totals[key] = totals.get(key, 0) + n
        for key, v in r["layouts"].items():
            for name, n in v.items():
                layouts.setdefault(key, {})
                layouts[key][name] = layouts[key].get(name, 0) + n
    t3 = time.perf_counter()
    numbers = dict(world_of_one=one, tp=dict(
        (k, v) for k, v in tp.items()
        if k not in ("unsharded_tokens", "sharded_tokens")),
        ranks=[dict(rank=r["rank"], shards=r["shards"],
                    k4_logged=r["k4_logged"]) for r in res],
        bench=bench, hot_swap=swap, transport="gloo, CUDA tensors through "
        "host memory", seconds=dict(world_of_one=t1 - t0, world=t2 - t1,
                                    checks=t3 - t2, total=t3 - t0,
                                    front=res[0]["seconds"]))
    log(f"[shard] took {t3 - t0:.1f} s: the world of one {t1 - t0:.1f}, "
        f"the {SHARD_WORLD}-rank world {t2 - t1:.1f}; launches {totals}")
    shutil.rmtree(work, ignore_errors=True)
    return numbers, totals, layouts


def host_copy_gbs(torch, dev):
    """The card's pinned host-copy rates (GB/s): device to host, host to
    device, each the median of 5 copies of HOST_COPY_BYTES timed with CUDA
    events (the gloo transport's two legs)."""
    n = HOST_COPY_BYTES // 4
    d = torch.empty(n, device=dev)
    h = torch.empty(n, pin_memory=True)
    out = {}
    for name, (dst, src) in (("d2h", (h, d)), ("h2d", (d, h))):
        ms = []
        for _ in range(6):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        ms = sorted(ms[1:])
        out[name] = HOST_COPY_BYTES / (ms[len(ms) // 2] * 1e-3) / 1e9
    del d, h
    return out


def _fleet_overhead(torch, dev, fleet, registry, collectives, mesh):
    """bench.py:1677 on the port: the same step (all_reduce of the rows'
    sum, ring_permute, an update) on the card's tensors over the gloo
    mesh, fleet off against armed in interleaved rounds, the minimum of
    each leg. Returns (off ms, on ms, overhead %, census counted)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch.parallel.mesh import mesh_scope

    o = FLEET_OVERHEAD
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (o["n"], o["n"]))
                         .astype("float32")).to(dev)

    def step(a):
        g = collectives.all_reduce(a.sum(dim=0), "dp")
        h = collectives.ring_permute(a, "dp")
        return a + 0.1 * h + g / collectives.axis_size("dp")

    def leg(armed):
        if armed:
            fleet.enable()
        try:
            with mesh_scope(mesh), torch.no_grad():
                y = step(x)
                for _ in range(o["warmup"]):
                    y = step(y)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(o["iters"]):
                    y = step(y)
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / o["iters"]
        finally:
            if armed:
                fleet.disable()

    offs, ons = [], []
    for _ in range(o["rounds"]):
        offs.append(leg(False))
        ons.append(leg(True))
    counted = any(k.startswith("mx_collective_trace_calls_total")
                  for k in registry.report())
    off, on = min(offs), min(ons)
    return off, on, (on - off) / off * 100.0, counted


def fleet_worker(rank, n, store, out):
    """One rank of [fleet]'s gloo world on cuda:0 (this script with
    ``--fleet-worker``): the straggler, the spans, the kvstore command,
    bench.py:1677's pair and the collectives' probe; rank
    FLEET_CRASH_RANK then raises, and every other rank waits at exit for
    its crash marker (the fanout dumps ``peer_crash``)."""
    import atexit
    import glob
    import os

    import torch

    os.environ["PROCESS_ID"], os.environ["NUM_PROCESSES"] = str(rank), str(n)
    from incubator_mxnet_tpu_torch import kv, profiler
    from incubator_mxnet_tpu_torch.fault import injection
    from incubator_mxnet_tpu_torch.parallel import collectives, make_mesh
    from incubator_mxnet_tpu_torch.telemetry import fleet, registry, tracing

    dev, dist = _worker_join(torch, rank, n, store)
    res = {"rank": rank}
    try:
        fleet.PEAK_LINK_GBS["host"] = float(os.environ["MX_SMOKE_HOST_GBS"])
        tracing.enable()
        fleet.enable()
        injection.configure_injection(
            {"collective_delay@1": (1.0, 0, 64)})
        dist.barrier("warmup")
        fleet.estimate_clock_offsets(rounds=3)
        for i in range(4):
            t0 = time.perf_counter()
            time.sleep(0.25 if rank == 1 else 0.01)
            registry.step(time.perf_counter() - t0, examples=8)
            dist.barrier(f"step{i}")
        res["fired"] = injection.schedule_info()["collective_delay"]["fired"]
        injection.clear_injection()
        rep = fleet.fleet_report()
        res["straggler"] = rep["straggler"]
        res["n_ranks"] = rep["n_ranks"]
        res["barrier"] = fleet.barrier_stats()
        fleet.dump_rank_trace(os.path.join(out, "spans"))
        store_ = kv.create("dist_sync")
        if rank == 1:
            profiler.set_config(profile_process="server",
                                filename="from_rank1.json")
        store_.barrier()
        res["profiler_filename"] = profiler._CONFIG.get("filename")
        fleet.disable()
        mesh = make_mesh({"dp": n})
        res["overhead"] = _fleet_overhead(torch, dev, fleet, registry,
                                          collectives, mesh)
        fleet.enable()
        res["probe"] = fleet.probe_collectives(mesh=mesh, nbytes=1 << 22,
                                               iters=3)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier("final")
    finally:
        dist._shutdown()
    if rank == FLEET_CRASH_RANK:
        raise RuntimeError(f"injected fleet crash (rank {rank})")
    marker = os.path.join(os.environ["MXNET_FLIGHTREC_DIR"],
                          f"fleet_crash_rank{FLEET_CRASH_RANK:03d}.marker")

    def wait_for_marker():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not glob.glob(marker):
            time.sleep(0.05)

    # atexit runs last in first: this waits before the fleet's own check
    atexit.register(wait_for_marker)
    return 0


def phase_fleet(torch, dev):
    """[fleet] (see the constants above); returns its numbers."""
    import os
    import shutil

    from incubator_mxnet_tpu_torch.telemetry import fleet

    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "fleet_smoke")
    shutil.rmtree(work, ignore_errors=True)
    flight = os.path.join(work, "flight")
    os.makedirs(flight)
    gbs = host_copy_gbs(torch, dev)
    peak = min(gbs.values())
    rcs, outs = _worker_spawn(
        "fleet", FLEET_WORLD, os.path.join(work, "store"), work,
        FLEET_TIMEOUT_S, env={"MX_SMOKE_HOST_GBS": repr(peak),
                              "MXNET_FAULT_DELAY_MS": "120",
                              "MXNET_FLIGHTREC_DIR": flight})
    want_rcs = [1 if r == FLEET_CRASH_RANK else 0 for r in range(FLEET_WORLD)]
    check(rcs == want_rcs, f"[fleet] return codes {rcs}; {want_rcs} "
          "expected:\n" + "\n".join(f"--- rank {r} ---\n{o[-3000:]}"
                                    for r, o in enumerate(outs)))
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(FLEET_WORLD)]
    for r in res:
        check(r["n_ranks"] == FLEET_WORLD and r["straggler"]["rank"] == 1,
              f"[fleet] rank {r['rank']}'s report names rank "
              f"{r['straggler']['rank']} ({r['straggler']}); rank 1, "
              "slowed by collective_delay, expected")
        check((r["fired"] > 0) == (r["rank"] == 1),
              f"[fleet] collective_delay fired {r['fired']} times on rank "
              f"{r['rank']}")
        check(r["profiler_filename"] == "from_rank1.json",
              f"[fleet] rank {r['rank']}: the server command did not arrive")
    stitched = fleet.stitch_traces(os.path.join(work, "spans"))
    lanes = sorted({e["pid"] for e in stitched["traceEvents"]
                    if e["ph"] == "X"})
    check(lanes == [3000 + r for r in range(FLEET_WORLD)],
          f"[fleet] the stitched trace's lanes {lanes}")
    merged = fleet.merge_flight_dumps(flight)
    peers = sorted(int(r) for r, ds in merged["ranks"].items()
                   if any(d["reason"] == "peer_crash" for d in ds))
    survivors = [r for r in range(FLEET_WORLD) if r != FLEET_CRASH_RANK]
    check([m["rank"] for m in merged["markers"]] == [FLEET_CRASH_RANK]
          and peers == survivors,
          f"[fleet] the crash fanout: markers {merged['markers']}, "
          f"peer_crash flightrecs on ranks {peers}; {survivors} expected")
    off, on, pct, counted = res[0]["overhead"]
    check(counted, "[fleet] the armed legs counted no collective census")
    probe = res[0]["probe"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rates = ", ".join(f"{op} {v['gbs']} GB/s ({v['peak_frac']} of the host "
                      "copy rate)" for op, v in probe.items()
                      if op != "_meta")
    log(f"[fleet] {FLEET_WORLD} gloo ranks on the card ({smi}): every "
        f"rank's fleet_report names rank 1 (z {res[0]['straggler']['score']}"
        f"); the stitched trace has lanes {lanes}; rank "
        f"{FLEET_CRASH_RANK}'s crash left its marker and peer_crash "
        f"flightrecs on ranks {peers}; a 'server' profiler command queued "
        f"on rank 1 reached every rank at a kvstore barrier; bench.py:1677's"
        f" step off {off:.4f} ms, armed {on:.4f} ms: {pct:+.2f} %; the "
        f"card's pinned host copies {gbs['d2h']:.2f} GB/s to the host, "
        f"{gbs['h2d']:.2f} GB/s to the card (the gloo peak: "
        f"{peak:.2f}); probe_collectives at "
        f"{probe['_meta']['per_shard_bytes']} B a rank: {rates}")
    numbers = dict(straggler=res[0]["straggler"], lanes=len(lanes),
                   peer_crash_ranks=peers, overhead=dict(
                       off_ms=off, on_ms=on, pct=pct),
                   host_copy_gbs=gbs, probe=probe, card=smi,
                   seconds=time.perf_counter() - t0)
    shutil.rmtree(work, ignore_errors=True)
    return numbers


# ---------------------------------------------------------------------------
# [int8]: bench.py:1754's int8 ResNet-50 pair on the port (Q1, Q2)
# ---------------------------------------------------------------------------

INT8_B, INT8_SIZE = 64, 224          # bench.py:1754 (bench_resnet50_infer_pair)
INT8_CALIB = 8                       # calib_data=[x[:8]], calib_mode="naive"
INT8_ROUNDS, INT8_ITERS = 3, 10      # bench.py's interleaved rounds
INT8_CHECK_B = 8                     # the kernel path against the plain one
INT8_CPU_B = 2                       # the card against the CPU
# the card's quantized net against the same net on the CPU (every parameter
# and threshold copied), max|d| / max|cpu logit|: the int32 sums are exact
# on both and each elementwise op of the chain is IEEE on both; the global
# average pool sums in another order, so a mean at a rounding tie can move
# one of the Dense's input codes by one step
INT8_CPU_TOL = 1e-2
# quantize_net's rewrite of resnet50_v1, counted from its log: the
# reference's counts for the same architecture (its quantize_net on
# resnet50_v1 logs the same); the CPU port's rewrite is held to them by
# tests/test_torch_quantization.py::test_resnet50_census_is_the_one_chip_
# smoke_checks
INT8_CENSUS = {"folded": 53, "quantized": 54, "requantize-chained": 32,
               "residual-chained": 16, "boundary-chained": 4}
INT8_LAUNCHES = {"Q1": 54, "Q2": 1}  # an eager forward's
INT8_FUSED = 16                      # Q1 launches with the residual add
INT8_TIME_REPS = 20
PEAK_INT8_OPS = 1979e12              # H100 SXM, dense int8 tensor cores
SRC = "incubator_mxnet_tpu_torch/csrc/"
Q1_REPLACES = ("incubator_mxnet_tpu/contrib/quantization.py:405 "
               "(lax.conv_general_dilated at preferred_element_type=int32, "
               "and :334 the Dense's dot_general; not a Pallas kernel)")
Q2_REPLACES = ("incubator_mxnet_tpu/numpy_extension/__init__.py:492 "
               "(lax.reduce_window max over int8 codes; not a Pallas "
               "kernel)")


class _Int8Log:
    """A logging handler counting quantize_net's rewrite messages by
    their first word."""

    def __init__(self):
        import collections
        import logging

        self.counts = collections.Counter()
        counts = self.counts

        class Handler(logging.Handler):
            def emit(self, record):
                counts[record.getMessage().split(" ")[0]] += 1

        self.logger = logging.getLogger("chip_smoke.int8")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(Handler())


def _int8_plain():
    """A context in which the quantized layers and npx.pooling run Q1's
    and Q2's plain versions on the card (the wrappers' impl="plain"): the
    net on the plain path, which the kernel path is held against."""
    import contextlib
    import functools

    from incubator_mxnet_tpu_torch.ops import quantized as q

    @contextlib.contextmanager
    def ctx():
        saved = {n: getattr(q, n) for n in ("conv_int8", "dense_int8",
                                            "max_pool_int")}
        try:
            for n, fn in saved.items():
                setattr(q, n, functools.partial(fn, impl="plain"))
            yield
        finally:
            for n, fn in saved.items():
                setattr(q, n, fn)

    return ctx()


def _int8_layers(net):
    """The quantized layers in forward order with their class (stem, 1x1,
    3x3, dense), and the stem's max pool."""
    from incubator_mxnet_tpu_torch.contrib import quantization as cq
    from incubator_mxnet_tpu_torch.gluon import nn

    layers, pool = [], None
    for m in net.modules():
        if isinstance(m, cq.QuantizedDense):
            layers.append(("dense", m))
        elif isinstance(m, cq.QuantizedConv2D):
            k = m.qweight.shape[2]
            layers.append(("stem" if k == 7 else f"{k}x{k}", m))
        elif isinstance(m, nn.MaxPool2D):
            pool = m
    return layers, pool


def _int8_capture(net, x, layers, pool):
    """One eager forward of ``net`` on ``x`` recording each quantized
    layer's input and keyword arguments (a residual block's last conv
    gets the block's other branch there), and the pool's, in forward
    order."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kw, c=c: seen.append((c, mod, args[0], kw)),
        with_kwargs=True) for c, m in layers]
    hooks.append(pool.register_forward_pre_hook(
        lambda mod, args: seen.append(("pool", mod, args[0], {}))))
    try:
        out = net(x)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def _int8_codes(torch, layer, xin):
    """The int8 codes Q1 reads for ``layer``'s input (a float input is
    quantized at the layer's threshold first, as its forward does)."""
    from incubator_mxnet_tpu_torch.contrib import quantization as cq

    t = getattr(xin, "_data", xin)
    if t.dtype == torch.int8:
        return t
    if isinstance(layer, cq.QuantizedDense) and t.dim() > 2:
        t = t.reshape(t.shape[0], -1)
    return cq._quantize_input(t, layer.qthreshold.data()._data)


def _q1_args(torch, layer, xq, kw=None):
    """(fn(xq, impl) -> Q1's output at the layer's own epilogue, its
    bytes and operations). With the forward's keyword arguments ``kw`` of
    a residual block's last conv, the epilogue the forward runs: the
    block's add, relu and requantize (or float output) after the code."""
    from incubator_mxnet_tpu_torch.contrib import quantization as cq
    from incubator_mxnet_tpu_torch.ops import quantized as q

    th = layer.qthreshold.data()._data
    ws = layer.qscale.data()._data
    wq = layer.qweight.data()._data
    b = None if layer.qbias is None else layer.qbias.data()._data
    ot = layer._out_threshold
    ot = None if ot is None else ot.data()._data
    od = torch.int8 if ot is not None else torch.float32
    kw = kw or {}
    # a body conv followed by relu glue relus its codes in its epilogue
    res = {"relu": True} if kw.get("relu") else {}
    if kw.get("residual") is not None:
        res = {k: getattr(kw[k], "_data", kw[k]) for k in (
            "residual", "residual_mode", "residual_t", "block_out_t")}
        od = kw["out_dtype"]
    if isinstance(layer, cq.QuantizedDense):
        def fn(a, impl="kernel"):
            return q.dense_int8(a, wq, th, ws, b, ot, od, impl=impl)
        out_shape = (xq.shape[0], wq.shape[0])
        cost = q.conv_cost(tuple(xq.shape) + (1, 1), tuple(wq.shape)
                           + (1, 1), out_shape, od)
    else:
        def fn(a, impl="kernel"):
            return q.conv_int8(a, wq, th, ws, b, ot, od, layer._stride,
                               layer._pad, layer._dilate, layer._groups,
                               impl=impl, **res)
        out = fn(xq)
        cost = q.conv_cost(tuple(xq.shape), tuple(wq.shape),
                           tuple(out.shape), od, "residual" in res)
    return fn, cost


def _int8_kernel_rows(torch, dev, seen):
    """Q1 at the stem, a stage-1 3x3, stage 4's and stage 1's last 1x1
    with their residuals (the block's add in the epilogue) and the Dense,
    and
    Q2 at the stem's pool, each at the forward's own tensors (the int8
    chain's channels-last codes, as the layer reads them): kernel and
    plain ms (CUDA graphs, inputs cycled beyond L2), the bound, the
    library yardstick (cuDNN's f32 and bf16 convolution of the shape, not
    the same function; torch._int_mm for the Dense's product and the
    stage-4 1x1's, on its channels-last rows (N*H*W, C) x (C, O), without
    the epilogue), the kernel against its plain version."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import quantized as q

    picks = {}
    fused = []
    for c, mod, xin, kw in seen:
        if kw.get("residual") is not None:
            fused.append((mod, xin, kw))
        if c == "stem" and "stem" not in picks:
            picks["stem"] = (mod, xin, None)
        elif c == "3x3" and "stage1_3x3" not in picks:
            picks["stage1_3x3"] = (mod, xin, kw)
        elif c == "1x1":
            # the forward's last 1x1: stage 4's last block, 512 -> 2048,
            # timed as the forward launches it, with the block's residual
            # add in its epilogue
            picks["stage4_1x1"] = (mod, xin, kw)
        elif c == "dense":
            picks["dense"] = (mod, xin, None)
        elif c == "pool":
            picks["pool"] = (mod, xin, None)
    # stage 1's third block: its last 1x1 (64 -> 256) with the identity
    picks["stage1_1x1_residual"] = fused[2]
    rows = []
    for name in ("stem", "stage1_3x3", "stage4_1x1", "stage1_1x1_residual",
                 "dense"):
        mod, xin, kw = picks[name]
        xq = _int8_codes(torch, mod, xin)
        check(xq.dim() == 2 or xq.is_contiguous(
            memory_format=torch.channels_last),
              f"int8: the {name}'s codes are not channels-last")
        fn, (nbytes, ops) = _q1_args(torch, mod, xq, kw)
        got, want = fn(xq), fn(xq, "plain")
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        sets = input_sets((xq,), INT8_TIME_REPS)
        ms = time_ms(fn, sets, INT8_TIME_REPS)
        plain_ms = time_ms(lambda a: fn(a, "plain"), sets[:2], 4)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_INT8_OPS * 1e3
        bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops \
            else (t_ops, "operations")
        wq = mod.qweight.data()._data
        row = dict(name=name, shape=f"x {tuple(xq.shape)} w "
                   f"{tuple(wq.shape)}"
                   + (" + residual" if kw and kw.get("residual") is not None
                      else "") + f" -> {getattr(got, 'dtype')}",
                   max_abs_err=err, bitwise=err == 0.0, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                   mac=ops // 2)
        if name == "dense":
            wt = wq.t()              # (K, O), column-major
            lib = time_ms(lambda a: torch._int_mm(a, wt), sets,
                          INT8_TIME_REPS)
            row.update(library_ms=lib, library="torch._int_mm (the int32 "
                       "product alone, no epilogue)")
        else:
            xf = [(s[0].float(),) for s in sets]
            wf = wq.float()
            st, pd = mod._stride, mod._pad
            f32 = time_ms(lambda a: F.conv2d(a, wf, None, st, pd), xf,
                          INT8_TIME_REPS)
            xb = [(s[0].to(torch.bfloat16),) for s in sets]
            wb = wq.to(torch.bfloat16)
            bf = time_ms(lambda a: F.conv2d(a, wb, None, st, pd), xb,
                         INT8_TIME_REPS)
            # and in NCHW, the unfused chain's layout
            xn = [(a.contiguous(),) for a, in xb]
            wn = wb.contiguous()
            bf_nchw = time_ms(lambda a: F.conv2d(a, wn, None, st, pd), xn,
                              INT8_TIME_REPS)
            row.update(library_ms=None, cudnn_f32_ms=f32, cudnn_bf16_ms=bf,
                       cudnn_bf16_nchw_ms=bf_nchw,
                       library="none computes an int8 convolution on CUDA; "
                       "cuDNN's f32 and bf16 convolution of the shape "
                       "(channels-last; bf16 NCHW too; TF32 off), not the "
                       "same function")
        if name == "stage4_1x1":
            # the same product on the channels-last rows: (N*H*W, C) rows
            # are a view of the codes, (C, O) column-major of the weight
            c_in = xq.shape[1]
            wt = wq.reshape(wq.shape[0], c_in).t()
            mm = time_ms(lambda a: torch._int_mm(
                a.permute(0, 2, 3, 1).reshape(-1, c_in), wt), sets,
                INT8_TIME_REPS)
            row.update(library_ms=mm, int_mm_ms=mm, library="torch._int_mm "
                       "of the product on the channels-last rows (N*H*W, "
                       "C) x (C, O), no epilogue; cuDNN's f32 and bf16 "
                       "convolution of the shape beside it")
        rows.append(row)
        log(f"[int8 Q1] {name} {row['shape']}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f}, bound {bound_ms:.4f} ({by}, share "
            f"{bound_ms / ms:.3f}), " + (
                f"torch._int_mm {row['library_ms']:.4f}" if name == "dense"
                else f"cuDNN f32 {row['cudnn_f32_ms']:.4f}, bf16 "
                f"{row['cudnn_bf16_ms']:.4f} (NCHW "
                f"{row['cudnn_bf16_nchw_ms']:.4f})")
            + (f", torch._int_mm of the product {row['int_mm_ms']:.4f}"
               if "int_mm_ms" in row else "")
            + f"; kernel vs plain max|d| {err}")
        check(err == 0.0, f"int8: Q1 at the {name} differs from its plain "
              f"version")
    mod, xin, _ = picks["pool"]
    xp = getattr(xin, "_data", xin)
    check(xp.dtype == torch.int8, f"int8: the stem's pool reads {xp.dtype}")
    check(xp.is_contiguous(memory_format=torch.channels_last),
          "int8: the stem's pool reads codes that are not channels-last")
    k, s, p = mod._kernel, mod._stride, mod._pad

    def pool(a, impl="kernel"):
        return q.max_pool_int(a, k, s, p, impl=impl)

    got, want = pool(xp), pool(xp, "plain")
    torch.cuda.synchronize()
    err = float((got.int() - want.int()).abs().max())
    sets = input_sets((xp,), INT8_TIME_REPS)
    ms = time_ms(pool, sets, INT8_TIME_REPS)
    plain_ms = time_ms(lambda a: pool(a, "plain"), sets[:2], 4)
    nbytes, ops = q.pool_cost(xp, tuple(got.shape), k)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    prow = dict(name="stem_pool", shape=f"{tuple(xp.shape)} int8 k{k} s{s} "
                f"p{p}", max_abs_err=err, bitwise=err == 0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None,
                library="none: PyTorch's CUDA max pooling takes floating "
                "types only")
    log(f"[int8 Q2] {prow['shape']}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, bound {bound_ms:.4f} (bytes, share "
        f"{bound_ms / ms:.3f}); kernel vs plain max|d| {err}")
    check(err == 0.0, "int8: Q2 differs from its plain version")
    return rows, prow


def _int8_split(torch, net, x, classes):
    """One replay's device ms by kernel from torch.profiler's events
    (three replays in the window, the last one's kernels): Q1 by layer
    class (the i-th Q1 launch of a forward is the i-th quantized layer;
    "1x1+add" a block's last conv with the residual in its epilogue), Q2,
    and the rest (torch's elementwise, copy and fill kernels: the input's
    quantization, the split-K workspace's zeroing, the global pool)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            net(x)
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    q1 = [e for e in evs if "int8_conv_kernel" in e.name]
    n = len(classes)
    if len(q1) < n:
        return {"lost": True, "q1_events": len(q1)}
    # the last replay: after the previous replay's last Q1 (its Dense)
    start = q1[-n - 1].time_range.end if len(q1) > n else None
    last = [e for e in evs if start is None or e.time_range.start >= start]
    out = {f"q1_{c}": 0.0 for c in sorted(set(classes))}
    for c, e in zip(classes, q1[-n:]):
        out[f"q1_{c}"] += (e.time_range.end - e.time_range.start) / 1e3
    out["q2"] = sum((e.time_range.end - e.time_range.start) / 1e3
                    for e in last if "int8_max_pool" in e.name)
    out["other"] = sum((e.time_range.end - e.time_range.start) / 1e3
                       for e in last if "int8_" not in e.name)
    out["q1"] = sum(v for k, v in out.items() if k.startswith("q1_"))
    out["total"] = out["q1"] + out["q2"] + out["other"]
    out["other_kernels"] = len([e for e in last if "int8_" not in e.name])
    return out


def _int8_torch_gaps(torch, dev):
    """What PyTorch itself refuses on the card, the reason for Q1 and Q2:
    an integer convolution (int32 operands, int32 sums) and an int8 max
    pooling, one call each; the error each raised (None had it run)."""
    import torch.nn.functional as F

    out = {}
    for name, call in (
            ("conv2d_int32", lambda: F.conv2d(
                torch.ones(1, 1, 4, 4, dtype=torch.int32, device=dev),
                torch.ones(1, 1, 3, 3, dtype=torch.int32, device=dev))),
            ("max_pool2d_int8", lambda: F.max_pool2d(
                torch.ones(1, 1, 4, 4, dtype=torch.int8, device=dev), 2))):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = None
        except (RuntimeError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    log(f"[int8] PyTorch on the card: {out}")
    return out


def phase_int8(torch, dev):
    """[int8]: `bench.py:1754` (`bench_resnet50_infer_pair`) on the port:
    resnet50_v1 at batch 64 x 3 x 224 x 224 (RandomState(0) uniform(-1,
    1)), seeded, an f32 net and its copy quantized by
    ``contrib.quantization.quantize_net(calib_data=[x[:8]],
    calib_mode="naive")``, both hybridized. The rewrite's census; the int8
    net on x[:8] through Q1/Q2 against the same net on their plain
    versions, bit for bit (and the int32 sums of the stem, a 3x3 and the
    Dense); the card against the CPU; Q1 and Q2 launches an eager forward;
    the kernels' rows; bench.py's interleaved timed pair; device ms a
    forward; fidelity against f32. Returns (numbers, launches, kernel
    rows)."""
    import copy

    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import np
    from incubator_mxnet_tpu_torch.contrib.quantization import quantize_net
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.ops import quantized as q

    t0 = time.perf_counter()
    smi = _obs_smi()
    gaps = _int8_torch_gaps(torch, dev)
    xn = onp.random.RandomState(0).uniform(
        -1, 1, (INT8_B, 3, INT8_SIZE, INT8_SIZE)).astype("float32")
    x = np.array(xn)
    mx.random.seed(0)
    net32 = resnet50_v1()
    net32.initialize()
    net32(x[:1])
    net8 = copy.deepcopy(net32)
    census = _Int8Log()
    tq = time.perf_counter()
    quantize_net(net8, calib_data=[x[:INT8_CALIB]], calib_mode="naive",
                 logger=census.logger)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - tq
    got_census = {k: census.counts.get(k, 0) for k in INT8_CENSUS}
    log(f"[int8] quantize_net(resnet50_v1, calib_data=[x[:{INT8_CALIB}]], "
        f"naive) in {quant_s:.2f} s: {got_census} (the reference's "
        f"{INT8_CENSUS})")
    check(got_census == INT8_CENSUS, f"int8: census {got_census}")
    layers, pool = _int8_layers(net8)

    # the main path: one eager forward through Q1/Q2, its launches counted
    xc = x[:INT8_CHECK_B]
    reset_counts()
    q.conv_launches = q.pool_launches = q.layout_conversions = 0
    got, seen = _int8_capture(net8, xc, layers, pool)
    torch.cuda.synchronize()
    launches = {"Q1": q.conv_launches, "Q2": q.pool_launches}
    conversions = q.layout_conversions
    # the forward's Q1 launches in order, a block's last conv with the
    # residual add in its epilogue as "1x1+add"
    classes = [c + ("+add" if kw.get("residual") is not None else "")
               for c, _, _, kw in seen if c != "pool"]
    fused = sum(c.endswith("+add") for c in classes)
    log(f"[int8] an eager forward on x[:{INT8_CHECK_B}]: launches "
        f"{launches} (expected {INT8_LAUNCHES}), {fused} of Q1's with the "
        f"residual add (expected {INT8_FUSED}), {conversions} layout "
        f"conversions; Q1 by layer class "
        + str({c: classes.count(c) for c in sorted(set(classes))}))
    check(launches == INT8_LAUNCHES, f"int8: launches {launches}")
    check(fused == INT8_FUSED, f"int8: {fused} residual blocks fused")
    check(conversions == 0, f"int8: {conversions} layout conversions in "
          f"the forward")
    with _int8_plain():
        want = net8(xc)
        torch.cuda.synchronize()
    check(q.conv_launches == INT8_LAUNCHES["Q1"],
          "int8: the plain path launched Q1")
    bitwise = torch.equal(got._data, want._data)
    sums = {}
    for c, mod, xin, _ in seen:
        key = {"stem": "stem", "3x3": "3x3", "dense": "dense"}.get(c)
        if key is None or key in sums:
            continue
        xq = _int8_codes(torch, mod, xin)
        fn, _ = _q1_args(torch, mod, xq)
        wq = mod.qweight.data()._data
        th, ws = mod.qthreshold.data()._data, mod.qscale.data()._data
        if key == "dense":
            a = q.dense_int8(xq, wq, th, ws, out_dtype=torch.int32,
                             impl="kernel")
            b = q.dense_int8(xq, wq, th, ws, out_dtype=torch.int32,
                             impl="plain")
        else:
            kw = dict(out_dtype=torch.int32, stride=mod._stride,
                      pad=mod._pad, dilate=mod._dilate, groups=mod._groups)
            a = q.conv_int8(xq, wq, th, ws, impl="kernel", **kw)
            b = q.conv_int8(xq, wq, th, ws, impl="plain", **kw)
        sums[key] = bool(torch.equal(a, b))
    log(f"[int8] kernel path against the plain path on the card, x[:"
        f"{INT8_CHECK_B}]: logits {'bit for bit' if bitwise else 'DIFFER'} "
        f"(max|d| {float((got._data - want._data).abs().max()):.3e}); "
        f"int32 sums equal: {sums}")
    check(bitwise, "int8: kernel-path logits differ from the plain path's")
    check(all(sums.values()) and len(sums) == 3, f"int8: int32 sums {sums}")

    # the card against the CPU
    cpu8 = _vision_on(mx, net8, mx.cpu())
    xs = xn[:INT8_CPU_B]
    with mx.cpu():
        ref = cpu8(np.array(xs)).asnumpy()
    card = net8(x[:INT8_CPU_B]).asnumpy()
    cpu_err = float(onp.abs(card - ref).max() / onp.abs(ref).max())
    log(f"[int8] the card's quantized net against the same net on the CPU "
        f"(parameters and thresholds copied), x[:{INT8_CPU_B}]: logits "
        f"within {cpu_err:.3e} of the CPU's largest (tol {INT8_CPU_TOL})")
    check(cpu_err <= INT8_CPU_TOL, "int8: card vs CPU logits")
    del cpu8

    # the kernels' rows at batch 64, and the whole net's kernel path
    # against its plain path at bench.py's batch
    got64, seen64 = _int8_capture(net8, x, layers, pool)
    with _int8_plain():
        want64 = net8(x)
        torch.cuda.synchronize()
    bitwise64 = torch.equal(got64._data, want64._data)
    log(f"[int8] kernel path against the plain path on the card, batch "
        f"{INT8_B}: logits {'bit for bit' if bitwise64 else 'DIFFER'} "
        f"(max|d| {float((got64._data - want64._data).abs().max()):.3e})")
    check(bitwise64, f"int8: kernel-path logits differ at batch {INT8_B}")
    rows, prow = _int8_kernel_rows(torch, dev, seen64)
    del seen64, seen, got64, want64

    # bench.py's timed pair on the hybridized nets
    net32.hybridize()
    net8.hybridize()

    def timed(net):
        y = net(x)
        float(y.sum().item())
        t1 = time.perf_counter()
        for _ in range(INT8_ITERS):
            y = net(x)
        float(y.sum().item())
        return INT8_B * INT8_ITERS / (time.perf_counter() - t1)

    timed(net32)
    timed(net8)
    f_rates, i_rates, ratios = [], [], []
    for _ in range(INT8_ROUNDS):
        f, i = timed(net32), timed(net8)
        f_rates.append(f)
        i_rates.append(i)
        ratios.append(i / f)
    ratios.sort()
    check(net8.captures == 1 and net32.captures == 1,
          f"int8: captures {net8.captures}, {net32.captures}")
    cen32 = profiled(torch, lambda: net32(x))
    cen8 = profiled(torch, lambda: net8(x))
    dev32, dev8 = census_ms(cen32), census_ms(cen8)
    # the replay's port kernels, each joined to its launch-log entry
    from incubator_mxnet_tpu_torch import profiler as mxprof
    port8 = [r for r in cen8["rows"] if mxprof.PORT_KERNEL.search(r["name"])]
    joined8 = dict(
        lost=cen8["meta"].get("lost_launches"),
        events=sum(r["count"] for r in port8),
        with_cost=sum(r["bytes_known"] for r in port8),
        kernels=sorted({mxprof.PORT_KERNEL.search(r["name"]).group(1)
                        for r in port8}))
    log(f"[int8] the profiled replay through mx.profiler: {joined8}")
    check(joined8["lost"] == 0
          and joined8["events"] == sum(INT8_LAUNCHES.values())
          and joined8["with_cost"] == joined8["events"],
          f"int8: the profiled replay's port kernels did not all join the "
          f"launch log: {joined8}")
    split = _int8_split(torch, net8, x, classes)
    log(f"[int8] {smi}: bench.py:1754 at batch {INT8_B}, {INT8_ROUNDS} "
        f"interleaved rounds of {INT8_ITERS} forwards (hybridized: one "
        f"capture each): f32 best {max(f_rates):.1f} images/s, int8 best "
        f"{max(i_rates):.1f}, median ratio {ratios[len(ratios) // 2]:.3f}; "
        f"device ms a forward (profiled replay): f32 {dev32:.3f}, int8 "
        f"{dev8:.3f} (ratio {dev32 / dev8:.3f}); int8 by kernel: "
        + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in split.items()))

    # fidelity, as the reference's test reports it
    y32, y8 = net32(x).asnumpy(), net8(x).asnumpy()
    agree = float((y32.argmax(1) == y8.argmax(1)).mean())
    rel = float(onp.abs(y8 - y32).max() / onp.abs(y32).max())
    cos = float((y8.ravel() @ y32.ravel()) / (onp.linalg.norm(y8)
                                              * onp.linalg.norm(y32)))
    log(f"[int8] fidelity on the {INT8_B} inputs: top-1 agreement with f32 "
        f"{agree:.4f}, logits max|d| / max|f32| {rel:.4f}, cosine "
        f"{cos:.5f}")
    check(onp.isfinite(y8).all() and y8.shape == (INT8_B, 1000),
          "int8: logits not finite or misshapen")
    seconds = time.perf_counter() - t0
    log(f"[int8] phase took {seconds:.1f} s")
    numbers = dict(
        card=smi, torch_gaps=gaps, census=got_census, quantize_s=quant_s,
        launches=launches, fused_residual_launches=fused,
        layout_conversions=conversions,
        kernel_vs_plain_bitwise=bitwise,
        kernel_vs_plain_bitwise_batch64=bitwise64, int32_sums_equal=sums,
        cpu_rel_err=cpu_err, f32_images_s=max(f_rates),
        int8_images_s=max(i_rates), median_ratio=ratios[len(ratios) // 2],
        rates=dict(f32=f_rates, int8=i_rates),
        device_ms=dict(f32=dev32, int8=dev8, ratio=dev32 / dev8),
        profiler_join=joined8, int8_split_ms=split, top1_agreement=agree, logit_rel_err=rel,
        cosine=cos, q1_rows=rows, q2_row=prow, seconds=seconds)
    del net8, net32
    return numbers, launches, (rows, prow)


# ---------------------------------------------------------------------------
# [rnn]: the RNN family on the card
# ---------------------------------------------------------------------------

RNN_T, RNN_N, RNN_C, RNN_H = 16, 8, 32, 64
# a layer's output and every gradient on the card against the CPU,
# normwise (f32 products summed in another order through 16 steps)
RNN_TOL = 1e-4
CHARLM_TOL = 1e-5                  # logits, of the largest
CHARLM_STEPS = 3


def _charlm(mx):
    g = mx.gluon

    class CharLM(g.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = g.nn.Embedding(28, 32)
            self.lstm = g.rnn.LSTM(64, num_layers=1, layout="NTC")
            self.head = g.nn.Dense(28, flatten=False)

        def forward(self, x):
            return self.head(self.lstm(self.embed(x)))

    net = CharLM()
    net.initialize()
    net(mx.np.zeros((1, 8), dtype="int32"))
    return net


def _nrel(a, b):
    import numpy as onp

    return float(onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30))


def phase_rnn(torch, dev):
    """[rnn]: the store's lstm_charlm_tiny on the card against the CPU; a
    2-layer bidirectional LSTM, a GRU and an rnn_tanh RNN, forward and
    gradients against the CPU; the fused layer's dropout between layers in
    training through K5 (p = 0.2: launches counted; p = 0: none, the
    predict-mode output bit for bit); three Trainer steps of the char LM,
    eager and hybridized."""
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, np
    from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store

    t0 = time.perf_counter()
    out = {}
    path = model_store.get_model_file("lstm_charlm_tiny")
    tokens = onp.random.RandomState(12).randint(0, 28, (2, 16)).astype(
        "int32")
    with mx.cpu():
        cpu = _charlm(mx)
        cpu.load_parameters(path)
        want = cpu(np.array(tokens)).asnumpy()
    card = _charlm(mx)
    card.load_parameters(path)
    got = card(np.array(tokens)).asnumpy()
    err = float(onp.abs(got - want).max() / onp.abs(want).max())
    out["charlm_rel_err"] = err
    log(f"[rnn] lstm_charlm_tiny (the store's file) on (2, 16) characters: "
        f"card logits within {err:.2e} of the CPU's largest (tol "
        f"{CHARLM_TOL})")
    check(err <= CHARLM_TOL and got.shape == (2, 16, 28), "rnn: char LM")

    r = onp.random.RandomState(3)
    xn = r.normal(size=(RNN_T, RNN_N, RNN_C)).astype("float32")
    layers = {"lstm_2layer_bi": lambda: gluon.rnn.LSTM(
        RNN_H, num_layers=2, bidirectional=True),
        "gru": lambda: gluon.rnn.GRU(RNN_H),
        "rnn_tanh": lambda: gluon.rnn.RNN(RNN_H, activation="tanh")}
    worst = {}
    for name, make in layers.items():
        with mx.cpu():
            mx.random.seed(5)
            cpu_l = make()
            cpu_l.initialize()
            cpu_l(np.array(xn))
        card_l = _vision_on(mx, cpu_l, mx.gpu(0))
        res = {}
        for tag, net, ctx in (("cpu", cpu_l, mx.cpu()),
                              ("card", card_l, mx.gpu(0))):
            with ctx:
                xa = np.array(xn)
                xa.attach_grad()
                dy = np.array(onp.random.RandomState(7).normal(
                    size=(RNN_T, RNN_N, net._dir * RNN_H)).astype("float32"))
                with autograd.record():
                    y = net(xa)
                    loss = (y * dy).sum()
                loss.backward()
                res[tag] = [y.asnumpy(), xa.grad.asnumpy(),
                            net.parameters.grad().asnumpy()]
        errs = [_nrel(a, b) for a, b in zip(res["card"], res["cpu"])]
        worst[name] = max(errs)
        log(f"[rnn] {name} (T {RNN_T}, N {RNN_N}, C {RNN_C}, H {RNN_H}): "
            f"output, dx and the flat parameters' gradient on the card "
            f"within {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e} of the "
            f"CPU's, normwise (tol {RNN_TOL})")
        check(worst[name] <= RNN_TOL, f"rnn: {name} card vs CPU")
    out["layers_rel_err"] = worst

    # dropout between layers in training: K5, its input at the layer
    # boundary and its key captured and held against the plain version
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import dropout as dp

    with mx.cpu():
        mx.random.seed(6)
        cpu_d = gluon.rnn.LSTM(RNN_H, num_layers=2, dropout=0.2)
        cpu_d.initialize()
        cpu_d(np.array(xn))
    card_d = _vision_on(mx, cpu_d, mx.gpu(0))
    xa = np.array(xn)
    seen, real = [], dp.dropout

    def spy(x, key, p, impl="auto"):
        y = real(x, key, p, impl=impl)
        seen.append((x.detach().clone(), key, p, y.detach().clone()))
        return y

    dp.dropout = spy
    try:
        reset_counts()
        with autograd.record():
            y = card_d(xa)
        y.backward()
        k5_p = read_counts()["K5"]
    finally:
        dp.dropout = real
    check(len(seen) == 1, f"rnn: {len(seen)} dropouts at the one boundary")
    xb, kb, pb, yb = seen[0]
    yk = dp.dropout_fwd(xb, kb, pb, impl="kernel")
    yp = dp.dropout_fwd(xb, kb, pb, impl="plain")
    torch.cuda.synchronize()
    keep = ph.keep_mask(xb.shape, kb, pb, device=dev)
    same = torch.equal(yk, yp) and torch.equal(yb, yk)
    mask = torch.equal(yk != 0, keep & (xb != 0))
    scale = float(((yk[keep].double() - xb[keep].double() / (1 - pb))
                   .abs() / xb[keep].double().abs().clamp_min(1e-30))
                  .max())
    kept = keep.float().mean().item()
    log(f"[rnn] K5 at the layer boundary, {tuple(xb.shape)} "
        f"{_dt(xb.dtype)} p={pb}: the path's output and the kernel's equal "
        f"the plain version bit for bit: {same}; mask equals the plain "
        f"Philox mask: {mask}; kept {kept:.5f}; kept values x / (1 - p) "
        f"within {scale:.2e} relative (tol 1e-6)")
    check(same and mask and scale <= 1e-6 and abs(kept - (1 - pb)) < 0.02
          and xb.shape == (RNN_T, RNN_N, RNN_H),
          "rnn: K5 at the layer boundary against its plain version")
    out["k5_boundary"] = dict(
        shape=list(xb.shape), p=pb, kept=kept, bitwise_plain=same,
        mask_equal=mask, max_abs_err=float((yk - yp).abs().max()))
    card_d._dropout = 0.0
    reset_counts()
    with autograd.train_mode():
        y0 = card_d(xa).asnumpy()
    k5_0 = read_counts()["K5"]
    y_pred = card_d(xa).asnumpy()
    cpu_d._dropout = 0.0
    with mx.cpu():
        with autograd.train_mode():
            y_cpu = cpu_d(np.array(xn)).asnumpy()
    p0_err = _nrel(y0, y_cpu)
    log(f"[rnn] 2-layer LSTM in training: p = 0.2 launched K5 {k5_p} times "
        f"(one forward and one backward at the layer boundary); p = 0: "
        f"{k5_0} launches, the output {'equal to' if (y0 == y_pred).all() else 'NOT'} "
        f"the predict-mode output bit for bit, within {p0_err:.2e} of the "
        f"CPU's (tol {RNN_TOL})")
    check(k5_p > 0 and k5_0 == 0 and (y0 == y_pred).all()
          and p0_err <= RNN_TOL, "rnn: dropout between layers")
    out.update(k5_launches_p02=k5_p, k5_launches_p0=k5_0,
               p0_rel_err_vs_cpu=p0_err)

    # three Trainer steps, eager and hybridized
    losses = {}
    rng = onp.random.RandomState(8)
    seqs = rng.randint(0, 28, (CHARLM_STEPS, 8, 17)).astype("int32")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for tag in ("eager", "hybridized"):
        net = _charlm(mx)
        net.load_parameters(path)
        if tag == "hybridized":
            net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5})
        losses[tag] = []
        for s in seqs:
            xt, yt = np.array(s[:, :-1]), np.array(s[:, 1:])
            with autograd.record():
                loss = loss_fn(net(xt), yt)
            loss.backward()
            tr.step(8)
            losses[tag].append(float(loss.mean().item()))
        if tag == "hybridized":
            caps = net.captures
    same = max(abs(a - b) / abs(b) for a, b in
               zip(losses["hybridized"], losses["eager"]))
    log(f"[rnn] lstm_charlm_tiny, {CHARLM_STEPS} Trainer steps (SGD, 8 x 16 "
        f"characters): eager losses {losses['eager']}, hybridized "
        f"{losses['hybridized']} ({caps} capture), max relative difference "
        f"{same:.2e}")
    check(same <= 1e-5 and losses["eager"][-1] < losses["eager"][0],
          "rnn: eager and hybridized Trainer steps")
    out.update(trainer_losses=losses, hybridized_captures=caps,
               seconds=time.perf_counter() - t0)
    log(f"[rnn] phase took {out['seconds']:.1f} s")
    return out


def _case_row(c, shape):
    """A case's entry in the kernels line; ``dtype`` names a mixed
    layout ("f32 x, bf16 h, f32 gamma") where it has one (an attention
    case's "bthd"/"bhtd" names its axes, not its dtypes)."""
    layout = c.get("layout", "")
    if layout in ("bthd", "bhtd"):
        layout = ""
    row = dict(shape=shape,
               dtype=_dt(c["dtype"]) if layout in ("", "f32", "bf16", "f16")
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
                 fold=None, int8=None):
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
    if int8 is not None:
        (rows, prow), counts = int8
        for name, src, rep, n, cases, main, lib in (
                ("int8_conv", "int8_conv.cu", Q1_REPLACES, counts["Q1"],
                 rows, rows[0], "cuDNN f32/bf16 convolution (not the same "
                 "function; library_ms null), torch._int_mm for the Dense "
                 "and the stage-4 1x1's product"),
                ("int8_max_pool", "int8_pool.cu", Q2_REPLACES, counts["Q2"],
                 [prow], prow, None)):
            out.append(dict(
                name=name, route="cuda", source=SRC + src, replaces=rep,
                launches=n, max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"],
                library=lib, cases=cases))
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
    if sys.argv[1:] == ["--only", "shard"]:
        # [shard] and [fleet] alone, after the build: no result line
        sharded, shard_launches, _ = phase_shard(torch, dev)
        fleet_numbers = phase_fleet(torch, dev)
        log(json.dumps({"shard": sharded, "fleet": fleet_numbers},
                       default=str))
        log(f"[done] [shard] and [fleet] alone: launches {shard_launches}")
        return 3
    if sys.argv[1:] == ["--only", "int8"]:
        # [int8] and [rnn] alone, after the build: no result line
        int8, int8_launches, _ = phase_int8(torch, dev)
        torch.cuda.empty_cache()
        rnn = phase_rnn(torch, dev)
        log(json.dumps({"int8": int8, "rnn": rnn}, default=str))
        log(f"[done] [int8] and [rnn] alone: launches {int8_launches}")
        return 3
    if sys.argv[1:] == ["--only", "dist"]:
        # [dist] alone, after the build: a short run, no result line
        distributed, dist_launches, _ = phase_dist(torch, dev)
        log(json.dumps({"dist": distributed}, default=str))
        log(f"[done] [dist] alone: launches {dist_launches}")
        return 3
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
    glu, glu_launches, glu_layouts = phase_gluon(
        torch, dev, {"module path, Trainer ([train amp])": trained_amp,
                     "module path, DataParallel ([train dp amp])": dp_amp})
    torch.cuda.empty_cache()
    for k, n in glu_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in glu_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [gluon]'s launches {glu_launches}: {launches}")
    amp16, amp16_launches, amp16_layouts = phase_amp16(torch, dev, dp_amp)
    torch.cuda.empty_cache()
    dense, dense_launches = phase_dense(torch, dev)
    torch.cuda.empty_cache()
    for k, n in dense_launches.items():
        amp16_launches[k] = amp16_launches.get(k, 0) + n
    for k, n in amp16_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in amp16_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [amp16]'s and [dense]'s p = 0.1 step's launches "
        f"{amp16_launches}: {launches}")
    vision, vision_launches = phase_vision(torch, dev)
    torch.cuda.empty_cache()
    for k, n in vision_launches.items():
        launches[k] = launches.get(k, 0) + n
    log(f"[done] with [vision]'s launches {vision_launches}: {launches}")
    np4, np4_launches, np4_layouts = phase_np4(torch, dev)
    torch.cuda.empty_cache()
    for k, n in np4_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in np4_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [np4]'s launches {np4_launches}: {launches}")
    observe, obs_launches, obs_layouts = phase_observe(torch, dev)
    torch.cuda.empty_cache()
    for k, n in obs_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in obs_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [observe]'s launches {obs_launches}: {launches}")
    fit, fit_launches, fit_layouts = phase_fit(torch, dev)
    torch.cuda.empty_cache()
    for k, n in fit_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in fit_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [fit]'s launches {fit_launches}: {launches}")
    pipeline = phase_pipeline(torch, dev)
    torch.cuda.empty_cache()
    distributed, dist_launches, dist_layouts = phase_dist(torch, dev)
    torch.cuda.empty_cache()
    for k, n in dist_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in dist_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [dist]'s launches {dist_launches}: {launches}")
    sharded, shard_launches, shard_layouts = phase_shard(torch, dev)
    torch.cuda.empty_cache()
    for k, n in shard_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, v in shard_layouts.items():
        for name, n in v.items():
            by_layout.setdefault(k, {})
            by_layout[k][name] = by_layout[k].get(name, 0) + n
    log(f"[done] with [shard]'s launches {shard_launches}: {launches}")
    fleet_numbers = phase_fleet(torch, dev)
    torch.cuda.empty_cache()
    int8, int8_launches, int8_rows = phase_int8(torch, dev)
    torch.cuda.empty_cache()
    rnn = phase_rnn(torch, dev)
    torch.cuda.empty_cache()
    launches["K5"] += rnn["k5_launches_p02"]
    log(f"[done] [int8]'s launches {int8_launches}; [rnn]'s K5 launches "
        f"{rnn['k5_launches_p02']}: K5 {launches['K5']}")
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
    # PERF.md §7's first-cycle question, asked after [elastic]
    reset_counts()
    observe["first_cycle"] = phase_observe_first_cycle(torch, dev)
    first_k4 = read_counts()["K4"]
    launches["K4"] += first_k4
    by_layout["K4"]["f32"] += first_k4
    torch.cuda.empty_cache()
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
    log(json.dumps({"gluon": glu}))
    log(json.dumps({"amp16": amp16}, default=str))
    log(json.dumps({"dense": dense}, default=str))
    log(json.dumps({"vision": vision}, default=str))
    log(json.dumps({"np4": np4}, default=str))
    log(json.dumps({"observe": observe}, default=str))
    log(json.dumps({"fit": fit}, default=str))
    log(json.dumps({"pipeline": pipeline}, default=str))
    log(json.dumps({"dist": distributed}, default=str))
    log(json.dumps({"shard": sharded}, default=str))
    log(json.dumps({"fleet": fleet_numbers}, default=str))
    log(json.dumps({"int8": int8}, default=str))
    log(json.dumps({"rnn": rnn}, default=str))
    log(json.dumps(kernels_line(attn, lns, launches, train_cases,
                                gd_cases, by_layout, fold_case,
                                (int8_rows, int8_launches))))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4], sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] in (["--shard-worker"], ["--fleet-worker"]):
        worker = shard_worker if sys.argv[1] == "--shard-worker" \
            else fleet_worker
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                        sys.argv[5]))
    sys.exit(main())
