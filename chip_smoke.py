#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds every CUDA kernel of the port from ``incubator_mxnet_tpu_torch/
   csrc/`` (``nvcc``, into ``build/torch_kernels/``) and prints the build
   time and each kernel's register / shared-memory report;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path, in float32 and bfloat16;
3. checks the end-to-end output on a small input (a tiny GPT on the card
   against the same weights on the CPU) and then serves three requests
   with ``gpt2_small`` at full width (768 units, 12 layers, 12 heads,
   vocab 50257, seeded random weights) through ``GPTModel.generate``,
   counting each kernel's launches in that run, and compares the logits
   with the same path on the plain versions, teacher-forced on the
   kernel path's tokens;
4. times each kernel, its plain version and one PyTorch library call
   that computes the same function (a yardstick the port never calls),
   with CUDA events over CUDA-graph replays whose inputs cycle through
   copies larger than the L2 cache, beside the least time the card could
   take for the same work.

Everything it has to say comes on earlier lines: the card's name and
power limit (``nvidia-smi``), one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result; so does a run without a CUDA device, or one outside a
checkout of the repository. TF32 is off for matmuls and cuDNN.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, the f32
# rate outside the tensor cores, the bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

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
# end to end, f32: logits of the kernel path vs the plain path after 12
# layers, relative to the largest logit
LOGIT_REL_TOL = 1e-3

REQUESTS = [(8, 100, 64), (4, 500, 32), (1, 1000, 16)]  # (batch, prompt, new)
ATTN_T = (128, 512, 1000)
N, H, D, C, LAYERS, VOCAB = 8, 12, 64, 768, 12, 50257


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


def tol_text(dtype, f32_tol):
    return (f"tol {f32_tol:g}" if dtype == "float32" else
            f"tol 2^-7*|plain| + {BF16_ATOL:g} elementwise")


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from incubator_mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} libraries in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p.name) for p in paths.values()))
    for stem, text in _build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {stem}: {line.strip()}")


def attn_cases(torch, dev):
    """K1 inputs as the prefill gives them: q, k, v strided views of one
    (N, T, 3, H, d) projection output, causal; plus one lengths case."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for t in ATTN_T:
            g = torch.Generator(device=dev).manual_seed(t)
            qkv = torch.randn(N, t, 3, H, D, generator=g, device=dev)
            cases.append(dict(base=qkv.to(dtype), lengths=None, causal=True,
                              layout="bthd", t=t, dtype=dtype))
    g = torch.Generator(device=dev).manual_seed(7)
    t = 512
    qkv = torch.randn(3, N, H, t, D, generator=g, device=dev)
    lens = torch.randint(1, t + 1, (N,), generator=g, device=dev)
    cases.append(dict(base=qkv, lengths=lens, causal=False, layout="bhtd",
                      t=t, dtype=torch.float32))
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
        ok, err, rel = agree(o, op, ATTN_TOL)
        fin = torch.isfinite(lsep)
        check(torch.equal(fin, torch.isfinite(lse)),
              f"K1 lse +inf rows differ ({c['t']}, {_dt(c['dtype'])})")
        lse_err = (lse[fin] - lsep[fin]).abs().max().item()
        c.update(max_abs_err=err, norm_rel_err=rel, lse_err=lse_err)
        log(f"[K1] T={c['t']} {_dt(c['dtype'])} causal={c['causal']} "
            f"lengths={c['lengths'] is not None}: max|o-plain|={err:.3e} "
            f"({tol_text(_dt(c['dtype']), ATTN_TOL)}: "
            f"{'ok' if ok else 'EXCEEDED'}), |o-plain|/|plain|={rel:.3e}, "
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
        t, dt = c["t"], _dt(c["dtype"])
        item = c["base"].element_size()
        if c["lengths"] is None:
            flops = 4 * N * H * t * t * D / (2 if c["causal"] else 1)
        else:  # rows and keys past each length are not needed
            flops = 4 * H * D * float((c["lengths"].double() ** 2).sum())
        c["bound_ms"], c["bound_by"] = bound(
            4 * N * H * t * D * item + N * H * t * 4, flops, dt)
        log(f"[time] K1 T={t} {dt} lengths={c['lengths'] is not None}: "
            f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
            f"sdpa {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
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


def _case_row(c, shape):
    return dict(shape=shape, dtype=_dt(c["dtype"]),
                max_abs_err=c["max_abs_err"],
                norm_rel_err=c["norm_rel_err"], ms=c["ms"],
                plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                bound_by=c["bound_by"], library_ms=c["library_ms"])


def kernels_line(attn, lns, launches):
    def entry(name, source, replaces, n, cases, main, library):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n,
                    max_abs_err=max(c["max_abs_err"] for c, _ in cases),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shape=main["shape"],
                    dtype=main["dtype"], library=library,
                    cases=[_case_row(c, s) for c, s in cases])

    a_cases = [(c, f"N={N} H={H} T={c['t']} d={D} "
                + ("causal bthd" if c["lengths"] is None
                   else "lengths bhtd")) for c in attn]
    l_cases = [(c, f"({c['rows']}, {C})") for c in lns]
    # headline shape: the f32 prefill of the largest prompt
    a_main = _case_row(*next((c, s) for c, s in a_cases
                             if c["t"] == ATTN_T[-1] and _dt(c["dtype"])
                             == "float32"))
    l_main = _case_row(*next((c, s) for c, s in l_cases
                             if c["rows"] == N * ATTN_T[-1] and _dt(c["dtype"])
                             == "float32"))
    return {"kernels": [
        entry("flash_attention_fwd", "incubator_mxnet_tpu_torch/csrc/"
              "flash_attention.cu",
              "incubator_mxnet_tpu/ops/flash_attention.py:122",
              launches["K1"], a_cases, a_main,
              "torch.nn.functional.scaled_dot_product_attention"),
        entry("layer_norm_fwd", "incubator_mxnet_tpu_torch/csrc/"
              "layer_norm.cu", "incubator_mxnet_tpu/ops/layer_norm.py:63",
              launches["K4"], l_cases, l_main,
              "torch.nn.functional.layer_norm"),
    ]}


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
    phase_small_reference(torch, dev)
    launches, served = phase_serve(torch, dev)
    phase_times(torch, attn, lns)
    log(f"[done] phases took {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(json.dumps({"serve": served}))
    log(json.dumps(kernels_line(attn, lns, launches)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
