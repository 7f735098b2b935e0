#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds every CUDA kernel of the port from ``incubator_mxnet_tpu_torch/
   csrc/`` (``nvcc``, into ``build/torch_kernels/``) and prints the build
   time and each kernel's register / shared-memory report; for the
   flash-attention kernels also their tensor-core instructions (SASS
   ``HGMMA``/``HMMA`` from ``cuobjdump``), failing on a register spill or
   a kernel with products but no tensor-core instruction;
2. holds each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16: the forward kernels at the shapes of the serving
   path (flash attention also at the training step's call), the training
   kernels (flash-attention backward, fused residual +
   dropout + LayerNorm forward and backward, LayerNorm backward, dropout)
   at the shapes of the BERT-base training step, dropout masks bit for
   bit;
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
   busy time of one step from ``torch.profiler``;
6. drives ``npx.gelu_dropout`` (the fused exact-erf GELU + dropout
   kernel, K6, forward and backward) at BERT-base's FFN width and the
   training step's token count: x (64, 128, 768) through
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
   card could take for the same work.

Everything it has to say comes on earlier lines: the card's name and
power limit (``nvidia-smi``), ``{"train": ...}``, ``{"serve": ...}`` and
``{"gelu_dropout": ...}`` lines, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
and prints no result; so does a run without a CUDA device, or one
outside a checkout of the repository. TF32 is off for matmuls and cuDNN.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, the f32
# rate outside the tensor cores, the bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
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
                 "K3b": 24 * 2, "K5": 50, "K6f": 0, "K6b": 0}
FWD_LAUNCHES = {"K1": 12, "K2": 0, "K4": 2, "K4b": 0, "K3f": 24, "K3b": 0,
                "K5": 25, "K6f": 0, "K6b": 0}

# the K6 slice: npx.gelu_dropout at BERT-base's FFN hidden. Kernel vs
# plain, float32: max abs 2e-6 at unit-normal inputs (one erff and expf an
# element on both sides, rounded in another order). The path, float32:
# the output and every gradient within 1e-4 of its own largest magnitude
# (two 768/3072-deep matrix products around the kernel).
GD_TOL = 2e-6
GD_PATH_REL_TOL = 1e-4
GD_WARMUP, GD_STEPS = 1, 5
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


def phase_build():
    """Build every kernel; print each library's register report, and for
    each flash-attention kernel its tensor-core instructions (SASS
    ``HGMMA``/``HMMA`` counts from ``cuobjdump``), registers, spills and
    shared memory. Fails if a flash kernel that runs products has no
    tensor-core instruction or spills."""
    import ctypes

    from incubator_mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} libraries in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p.name) for p in paths.values()))
    logs = _build.build_logs()
    for stem, text in logs.items():
        if stem == "flash_attention":
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
    sass = {}
    if tool is None:
        log("[build] flash_attention: no cuobjdump found beside nvcc or in "
            "Triton; the tensor-core instruction check did not run")
    else:
        text = subprocess.run([tool, "-sass", str(paths["flash_attention"])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        cur = None
        for line in text.splitlines():
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
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows in [N * t for t in ATTN_T] + [N]:
            g = torch.Generator(device=dev).manual_seed(rows)
            x = (torch.randn(rows, C, generator=g, device=dev) * 2 + 0.5)
            gamma = 1 + 0.3 * torch.randn(C, generator=g, device=dev)
            beta = 0.3 * torch.randn(C, generator=g, device=dev)
            cases.append(dict(x=x.to(dtype), gamma=gamma.to(dtype),
                              beta=beta.to(dtype), rows=rows, dtype=dtype))
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
        log(f"[K4] ({c['rows']}, {C}) {_dt(c['dtype'])}: "
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
        sets = input_sets([x], 50)
        c["ms"] = time_ms(lambda x: ln.layer_norm_fwd(x, gm, bt,
                                                      impl="kernel"),
                          sets, 50)
        c["plain_ms"] = time_ms(lambda x: ln.layer_norm_fwd(
            x, gm, bt, impl="plain"), sets, 20)
        c["library_ms"] = time_ms(lambda x: F.layer_norm(x, (C,), gm, bt,
                                                         1e-5), sets, 50)
        rows, item = c["rows"], x.element_size()
        c["bound_ms"], c["bound_by"] = bound(
            2 * rows * C * item + 8 * rows + 2 * C * item, 8 * rows * C,
            _dt(c["dtype"]))
        log(f"[time] K4 ({rows}, {C}) {_dt(c['dtype'])}: kernel "
            f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, F.layer_norm "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), roofline share "
            f"{c['bound_ms'] / c['ms']:.3f}")


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
            "K6b": (fb, "gd_bwd_launches")}


def reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


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
    sites give them, f32 and bf16; K3 at p = 0.1 and p = 0."""
    k3, k4b = [], []
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(17)
        x = torch.randn(ROWS, C, generator=g, device=dev) + 0.3
        h = torch.randn(ROWS, C, generator=g, device=dev)
        dy = torch.randn(ROWS, C, generator=g, device=dev)
        gamma = 1 + 0.3 * torch.randn(C, generator=g, device=dev)
        beta = 0.3 * torch.randn(C, generator=g, device=dev)
        t = dict(x=x.to(dtype), h=h.to(dtype), dy=dy.to(dtype),
                 gamma=gamma.to(dtype), beta=beta.to(dtype), dtype=dtype)
        for p in (TRAIN_P, 0.0):
            k3.append(dict(t, p=p, key=(1234567, 7654321)))
        k4b.append(dict(t))
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


def _log_check(tag, what, c, ok, err, rel, tol):
    log(f"[{tag}] {what}: max|d|={err:.3e} "
        f"({tol_text(_dt(c['dtype']), tol)}: {'ok' if ok else 'EXCEEDED'}),"
        f" |d|/|plain|={rel:.3e}")
    check(ok, f"{tag} {what} disagrees with plain")


def _column_check(tag, what, c, got, ref, terms):
    """dgamma/dbeta: float32 within column_sum_tol of each column;
    bfloat16 by the elementwise rule."""
    import torch

    from incubator_mxnet_tpu_torch.ops.layer_norm import column_sum_tol

    d = (got.float() - ref.float()).abs()
    rel = (d.norm() / ref.float().norm().clamp_min(1e-30)).item()
    if c["dtype"] == torch.bfloat16:
        ok, err, rel = agree(got, ref, 0.0)
        _log_check(tag, what, c, ok, err, rel, 0.0)
        return err
    tol = column_sum_tol(terms, ROWS)
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
        args = (c["x"], c["h"], c["gamma"], c["beta"], c["key"], c["p"])
        y, m, r = fb.residual_dropout_ln_fwd(*args, impl="kernel")
        yp, mp, rp = fb.residual_dropout_ln_fwd(*args, impl="plain")
        bargs = (c["x"], c["h"], c["dy"], mp, rp, c["gamma"], c["key"],
                 c["p"])
        got = fb.residual_dropout_ln_bwd(*bargs, impl="kernel")
        ref = fb.residual_dropout_ln_bwd(*bargs, impl="plain")
        torch.cuda.synchronize()
        what = f"({ROWS}, {C}) {_dt(c['dtype'])} p={c['p']}"
        ok, err, rel = agree(y, yp, LN_TOL)
        serr = max((m - mp).abs().max().item(), (r - rp).abs().max().item())
        _log_check("K3 fwd", f"{what} y", c, ok and serr <= STATS_TOL, err,
                   rel, LN_TOL)
        log(f"[K3 fwd] {what} max|stats-plain|={serr:.3e} "
            f"(tol {STATS_TOL:g})")
        c["fwd_err"], c["fwd_rel"] = err, rel
        errs = []
        for name, gt, rf in zip(("dx", "dh"), got[:2], ref[:2]):
            ok, err, rel = agree(gt, rf, LN_TOL)
            _log_check("K3 bwd", f"{what} {name}", c, ok, err, rel, LN_TOL)
            errs.append(err)
        s = c["x"].float() + fb._dropped(c["h"], c["key"], c["p"])
        xhat = (s - mp[:, None]) * rp[:, None]
        dyf = c["dy"].float()
        errs.append(_column_check("K3 bwd", f"{what} dgamma", c, got[2],
                                  ref[2], (dyf * xhat).abs().sum(0)))
        errs.append(_column_check("K3 bwd", f"{what} dbeta", c, got[3],
                                  ref[3], dyf.abs().sum(0)))
        c["bwd_err"], c["bwd_rel"] = max(errs), rel
        if c["p"] > 0:  # the kernel's mask is the plain Philox mask
            keep = ph.keep_mask((ROWS, C), c["key"], c["p"], device=dev)
            same = torch.equal(got[1] != 0, keep & (ref[1] != 0))
            log(f"[K3 bwd] {what} mask (dh != 0) equals the plain Philox "
                f"mask: {same}")
            check(same, "K3 mask differs from the plain Philox mask")

    for c in k4b:
        _, mp, rp = ln.layer_norm_fwd(c["x"], c["gamma"], c["beta"],
                                      impl="plain")
        c.update(mean=mp, rstd=rp)
        bargs = (c["x"], c["dy"], mp, rp, c["gamma"])
        got = ln.layer_norm_bwd(*bargs, impl="kernel")
        ref = ln.layer_norm_bwd(*bargs, impl="plain")
        torch.cuda.synchronize()
        what = f"({ROWS}, {C}) {_dt(c['dtype'])}"
        ok, err, rel = agree(got[0], ref[0], LN_TOL)
        _log_check("K4b", f"{what} dx", c, ok, err, rel, LN_TOL)
        xhat = (c["x"].float() - mp[:, None]) * rp[:, None]
        dyf = c["dy"].float()
        errs = [err,
                _column_check("K4b", f"{what} dgamma", c, got[1], ref[1],
                              (dyf * xhat).abs().sum(0)),
                _column_check("K4b", f"{what} dbeta", c, got[2], ref[2],
                              dyf.abs().sum(0))]
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


def _device_ms(prof):
    """Sum of the device time of the kernels, copies and sets in a
    profiler trace, in ms (one stream, so their sum is the busy time)."""
    from torch.autograd import DeviceType

    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3


def phase_train(torch, dev):
    """The bench.py BERT-base training workload, 2 warm-up + 10 timed
    steps, launch counts per step, and one profiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_base
    from incubator_mxnet_tpu_torch.optimizer import Adam

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

    mxrandom.seed(0)
    losses, times, per_step = [], [], []
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
              f"train step {i}: launches {fwd[0]} after the forward, "
              f"{counts} after the step; expected {FWD_LAUNCHES}, "
              f"{STEP_LAUNCHES}")
        per_step.append(counts)
    timed = sorted(times[WARMUP:])
    med = timed[len(timed) // 2 - 1] / 2 + timed[len(timed) // 2] / 2
    totals = {k: sum(c[k] for c in per_step[WARMUP:]) for k in STEP_LAUNCHES}
    log(f"[train] BERT-base {TRAIN_B} x {TRAIN_T}, dropout {TRAIN_P}, Adam "
        f"lr {TRAIN_LR}, {n_params} parameters: step ms "
        + ", ".join(f"{t:.1f}" for t in times)
        + f" ({WARMUP} warm-up); loss " + ", ".join(f"{v:.4f}"
                                                    for v in losses))
    log(f"[train] launches per step {STEP_LAUNCHES} (forward "
        f"{FWD_LAUNCHES}): every step as expected")
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(losses[-1] < losses[WARMUP], "the loss did not fall")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev_ms = _device_ms(prof)
    tokens_s = TRAIN_B * TRAIN_T / (med / 1e3)
    flops_token = 6.0 * n_params + 12.0 * 12 * TRAIN_T * C
    share = flops_token * tokens_s / PEAK_FLOPS["float32"]
    idle = 1 - dev_ms / med if dev_ms > 0 else None
    log(f"[train] median step {med:.2f} ms, {tokens_s:.1f} tokens/s, "
        f"model FLOPs {flops_token:.4g}/token -> share of the f32 peak "
        f"{share:.4f}; device busy {dev_ms:.2f} ms of a step "
        f"(torch.profiler) -> idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured"))
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    for e in top[:14]:
        log(f"[train]   {getattr(e, 'self_device_time_total', 0) / 1e3:8.3f}"
            f" ms x{e.count:4d}  {e.key[:90]}")
    del model, trainer
    return dict(batch=TRAIN_B, seq=TRAIN_T, dropout=TRAIN_P, lr=TRAIN_LR,
                params=n_params, step_ms=times, warmup=WARMUP,
                median_step_ms=med, tokens_per_s=tokens_s,
                flops_per_token=flops_token, f32_peak_share=share,
                device_ms_per_step=dev_ms, idle_share=idle, losses=losses,
                launches_per_step=STEP_LAUNCHES), totals


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
        item, dt = c["x"].element_size(), _dt(c["dtype"])
        sets = input_sets([c["x"], c["h"]], 20)
        c["ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="kernel"), sets, 20)
        c["plain_ms"] = time_ms(lambda x, h: fb.residual_dropout_ln_fwd(
            x, h, gm, bt, key, p, impl="plain"), sets, 5)
        c["library_ms"] = time_ms(lambda x, h: F.layer_norm(
            x + F.dropout(h, p, training=True), (C,), gm, bt, 1e-5), sets,
            20)
        c["bound_ms"], c["bound_by"] = bound(
            3 * ROWS * C * item + 8 * ROWS + 2 * C * item, 10 * ROWS * C, dt)
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
            5 * ROWS * C * item + 8 * ROWS + 3 * C * item, 16 * ROWS * C, dt)
        log(f"[time] K3 ({ROWS}, {C}) {dt} p={p}: forward kernel "
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
        item, dt = c["x"].element_size(), _dt(c["dtype"])
        sets = input_sets([c["x"], c["dy"]], 20)
        c["ms"] = time_ms(lambda x, dy: ln.layer_norm_bwd(
            x, dy, m, r, gm, impl="kernel"), sets, 20)
        c["plain_ms"] = time_ms(lambda x, dy: ln.layer_norm_bwd(
            x, dy, m, r, gm, impl="plain"), sets, 5)

        def lib(x, dy, backward=True, c=c):
            xl = x.detach().requires_grad_()
            gl = c["gamma"].detach().requires_grad_()
            bl = c["beta"].detach().requires_grad_()
            y = F.layer_norm(xl, (C,), gl, bl, 1e-5)
            if backward:
                torch.autograd.grad(y, (xl, gl, bl), dy)

        c["library_ms"] = (time_ms(lib, sets, 20) - time_ms(
            lambda *a: lib(*a, backward=False), sets, 20))
        c["bound_ms"], c["bound_by"] = bound(
            3 * ROWS * C * item + 8 * ROWS + 3 * C * item, 12 * ROWS * C, dt)
        log(f"[time] K4b ({ROWS}, {C}) {dt}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, F.layer_norm backward "
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
        _log_check("K6 fwd", what, c, ok, err, rel, GD_TOL)
        c["fwd_err"], c["fwd_rel"] = err, rel
        del yp
        ok, err, rel = agree(du, dup, GD_TOL)
        _log_check("K6 bwd", what, c, ok, err, rel, GD_TOL)
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
    row = dict(shape=shape, dtype=_dt(c["dtype"]),
               max_abs_err=c["max_abs_err"],
               norm_rel_err=c["norm_rel_err"], ms=c["ms"],
               plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
               bound_by=c["bound_by"], library_ms=c["library_ms"])
    if "xla_ms" in c:
        row["xla_ms"] = c["xla_ms"]
    return row


def _pass_view(c, bwd):
    """A K3 or K6 case's forward or backward numbers under the common
    keys."""
    pre = "bwd_" if bwd else ""
    return dict(dtype=c["dtype"], max_abs_err=c["bwd_err" if bwd else
                                                 "fwd_err"],
                norm_rel_err=c["bwd_rel" if bwd else "fwd_rel"],
                ms=c[pre + "ms"], plain_ms=c[pre + "plain_ms"],
                bound_ms=c[pre + "bound_ms"], bound_by=c[pre + "bound_by"],
                library_ms=c[pre + "library_ms"], p=c["p"],
                **({"xla_ms": c[pre + "xla_ms"]} if pre + "xla_ms" in c
                   else {}))


def kernels_line(attn, lns, launches, train=None, gd=None):
    """The nine kernels' entries; ``train`` = (attn, k3, k4b, drop) of the
    training kernels' cases, ``gd`` the K6 cases."""
    def entry(name, source, replaces, n, cases, main, library):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n,
                    max_abs_err=max(c["max_abs_err"] for c, _ in cases),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shape=main["shape"],
                    dtype=main["dtype"], library=library,
                    cases=[_case_row(c, s) for c, s in cases])

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
              "torch.nn.functional.layer_norm"),
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
    f_cases = [(_pass_view(c, False), f"({ROWS}, {C}) p={c['p']}") for c in k3]
    g_cases = [(_pass_view(c, True), f"({ROWS}, {C}) p={c['p']}") for c in k3]
    n_cases = [(c, f"({ROWS}, {C})") for c in k4b]
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
              "autograd backward of torch.nn.functional.layer_norm"),
        entry("residual_dropout_ln_fwd", src + "fused_block.cu",
              ref + "fused_block.py:133", launches["K3f"], f_cases,
              first(f_cases, lambda c: f32(c) and c["p"] > 0),
              "composed: F.dropout + add + F.layer_norm (no single call)"),
        entry("residual_dropout_ln_bwd", src + "fused_block.cu",
              ref + "fused_block.py:169", launches["K3b"], g_cases,
              first(g_cases, lambda c: f32(c) and c["p"] > 0),
              "composed: autograd backward of F.dropout + add + "
              "F.layer_norm (no single call)"),
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
    gd_cases = phase_gelu_dropout_vs_plain(torch, dev)
    phase_small_reference(torch, dev)
    launches, served = phase_serve(torch, dev)
    check_result = phase_train_step_check(torch, dev)
    torch.cuda.empty_cache()
    trained, train_launches = phase_train(torch, dev)
    trained["check"] = check_result
    torch.cuda.empty_cache()
    gd_path, gd_launches = phase_gelu_dropout_path(torch, dev)
    torch.cuda.empty_cache()
    for k, n in list(train_launches.items()) + list(gd_launches.items()):
        launches[k] = launches.get(k, 0) + n
    log(f"[done] launches on the main paths (serving + {STEPS} timed "
        f"training steps + {GD_STEPS} gelu_dropout steps): {launches}")
    phase_times(torch, attn, lns)
    phase_times_train(torch, *train_cases)
    phase_times_gelu_dropout(torch, gd_cases)
    log(f"[done] phases took {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(json.dumps({"train": trained}))
    log(json.dumps({"serve": served}))
    log(json.dumps({"gelu_dropout": gd_path}))
    log(json.dumps(kernels_line(attn, lns, launches, train_cases,
                                gd_cases)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
