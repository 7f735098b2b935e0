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
   f32 and bitwise equal across two calls;
3. checks the end-to-end output on a small input (a tiny GPT on the card
   against the same weights on the CPU) and then serves three requests
   with ``gpt2_small`` at full width (768 units, 12 layers, 12 heads,
   vocab 50257, seeded random weights) through ``GPTModel.generate``,
   counting each kernel's launches in that run, and compares the logits
   with the same path on the plain versions, teacher-forced on the
   kernel path's tokens;
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
   card could take for the same work; the row backward's device time
   split by kernel (``torch.profiler``).

Everything it has to say comes on earlier lines: the card's name and
power limit (``nvidia-smi``), ``{"train": ...}``, ``{"train_amp": ...}``,
``{"train_tf32": ...}``, ``{"train_dp_amp": ...}``, ``{"train_dp": ...}``,
``{"serve": ...}`` and ``{"gelu_dropout": ...}`` lines, one
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


def time_ms(fn, sets, reps):
    """Device time of one call of ``fn``: CUDA events around the replay of
    a CUDA graph holding ``reps`` calls (no host launch cost between
    calls) that cycle through the argument ``sets``, after an eager
    warm-up call."""
    import torch

    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fn(*sets[i % len(sets)])
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
    paths = _build.build_all()
    log(f"[build] {len(paths)} libraries in "
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


def ln_cases(torch, dev):
    """K4 inputs at the serving path's rows, f32 and bf16; and in AMP's
    layout, bf16 x with f32 gamma/beta, at the training step's rows (the
    MLM LayerNorm) and at N rows."""
    from incubator_mxnet_tpu_torch.ops.layer_norm import layout_name

    f32, bf16 = torch.float32, torch.bfloat16
    specs = [(dt, dt, rows) for dt in (f32, bf16)
             for rows in [N * t for t in ATTN_T] + [N]]
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
    for c in lns:
        x, gm, bt = c["x"], c["gamma"], c["beta"]
        lib, c["library"] = layer_norm_library(torch, x, gm, bt)
        sets = input_sets([x], 50)
        c["ms"] = time_ms(lambda x: ln.layer_norm_fwd(x, gm, bt,
                                                      impl="kernel"),
                          sets, 50)
        c["plain_ms"] = time_ms(lambda x: ln.layer_norm_fwd(
            x, gm, bt, impl="plain"), sets, 20)
        c["library_ms"] = time_ms(lambda x: lib(x, gm, bt), sets, 50)
        rows, ix, ip = c["rows"], x.element_size(), gm.element_size()
        c["bound_ms"], c["bound_by"] = bound(
            2 * rows * C * ix + 8 * rows + 2 * C * ip, 8 * rows * C,
            _ops_dtype(c))
        log(f"[time] K4 ({rows}, {C}) {c['layout']}: kernel "
            f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
            f"{c['library']} {c['library_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), roofline share "
            f"{c['bound_ms'] / c['ms']:.3f}")


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
                            ln.bwd_blocks(rows, ln.sm_count(got.device)))
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
    from torch.profiler import ProfilerActivity, profile

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

        # one profiled replay. The card spins ~25 ms first: a replay that
        # starts on the card as tracing starts can lose its first kernels'
        # records (seen once in a full run); a short trace is profiled
        # again, at most three times, and the tries are reported
        for tries in range(1, 4):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(SPIN_CYCLES)
                dps[0].step(tokens, labels)
                torch.cuda.synchronize()
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
        sets = input_sets([c["x"], c["h"]], 20)
        c["ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="kernel"), sets, 20)
        c["plain_ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="plain"), sets, 5)
        c["library_ms"] = time_ms(lambda x, h: F.layer_norm(
            x + F.dropout(h, p, training=True), (C,), gm, bt, 1e-5), sets,
            20)
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
    train_cases = phase_train_kernels_vs_plain(torch, dev)
    phase_row_bwd_checks(torch, dev)
    gd_cases = phase_gelu_dropout_vs_plain(torch, dev)
    gd_accuracy = phase_gelu_accuracy(torch, dev)
    phase_small_reference(torch, dev)
    launches, served = phase_serve(torch, dev)
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
    by_layout["K4"]["f32"] += sum(r["k4_launches"] for r in served)
    log(f"[done] launches on the main paths (serving + {STEPS} timed "
        f"training steps in f32 and {STEPS} under AMP + the DataParallel "
        f"steps, AMP and f32, that launched through the wrappers: the "
        f"eager and the capturing step of each + {GD_STEPS} gelu_dropout "
        f"steps): {launches}; the row kernels' by layout {by_layout}")
    phase_times(torch, attn, lns)
    phase_times_train(torch, *train_cases)
    phase_times_gelu_dropout(torch, gd_cases)
    key_times = phase_times_device_keys(torch, fold_case)
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
    gd_path["max_abs_err_vs_float64"] = {
        name: {"k6": k6, "erff": erff}
        for name, (k6, erff) in gd_accuracy.items()}
    log(json.dumps({"gelu_dropout": gd_path}))
    log(json.dumps(kernels_line(attn, lns, launches, train_cases,
                                gd_cases, by_layout, fold_case)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
