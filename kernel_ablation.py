#!/usr/bin/env python3
"""Time variants of the port's K6 (fused GELU + dropout) and row-backward
(K4b, K3 backward) kernels on one CUDA card, in one run.

Run from the root of a checkout: ``python3 kernel_ablation.py [--parent
DIR]``. A variant is the source of ``incubator_mxnet_tpu_torch/csrc``
with named text substitutions: a part of the work taken out (the normal
tail's rational function, Philox, the dgamma/dbeta reduction) or a
design choice changed (erff for the tail, Philox's multiplies, vectors a
thread; where the row backward keeps its row and its sums, blocks an SM,
the reduction's warps). A row-backward variant runs on its own grid
(blocks an SM x SMs). Each is built by ``nvcc`` with the port's flags
into ``build/ablation/<variant>/``. ``--parent DIR`` adds the sources of
another checkout's ``incubator_mxnet_tpu_torch/csrc`` (the parent
commit, unpacked with ``git archive``) as the variant "parent", called
as its own wrappers call it (its row-kernel entries must take a dtype code
for each operand, as they do since the mixed layouts). Every variant's C
entry is called directly
on the same inputs: one discarded round, then in turns (the variants in
order, then in reverse), timed as ``chip_smoke.py`` times kernels (CUDA
events over CUDA-graph replays whose inputs cycle beyond the L2 cache).
Prints one line per case and variant, the card's name and power limit,
then one JSON line (also written to
``chiprun_out/kernel_ablation.json``). A variant without the work it
names computes a wrong result: only its time means anything.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ablation"

# (variant, source stem, [(old text, new text), ...]); every old text must
# occur in the source
K6_VARIANTS = [
    ("as is", "gelu_dropout", []),
    ("erff and expf", "gelu_dropout",
     [("  const float z = fminf(fabsf(u), 16.f);\n",
       "  return {0.5f * (1.f + erff(u * 0.70710678118654752f)),\n"
       "          expf(-0.5f * u * u) * kInvSqrt2Pi};\n"
       "  const float z = fminf(fabsf(u), 16.f);\n")]),
    ("no rational tail", "gelu_dropout",
     [("e * fmaf(-z, r * rcp_approx(q), 0.5f);", "e * 0.5f;")]),
    ("no Philox", "gelu_dropout",
     [("      mx::philox_words<E>(static_cast<unsigned long long>(i), key, "
       "words);",
       "      for (int e = 0; e < E; ++e) words[e] = "
       "static_cast<unsigned>(i + e) * 2654435761u;")]),
    ("Philox as wide multiplies", "gelu_dropout",
     [("const unsigned lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, "
       "c0);",
       "const unsigned long long p0 = 0xD2511F53ull * c0; const unsigned "
       "lo0 = static_cast<unsigned>(p0), hi0 = p0 >> 32;"),
      ("const unsigned lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, "
       "c2);",
       "const unsigned long long p1 = 0xCD9E8D57ull * c2; const unsigned "
       "lo1 = static_cast<unsigned>(p1), hi1 = p1 >> 32;")]),
    ("1 vector a thread", "gelu_dropout",
     [("constexpr int kVecs = sizeof(T) == 2 ? 2 : 1;",
       "constexpr int kVecs = 1;")]),
    ("2 vectors a thread", "gelu_dropout",
     [("constexpr int kVecs = sizeof(T) == 2 ? 2 : 1;",
       "constexpr int kVecs = 2;")]),
    ("4 vectors a thread", "gelu_dropout",
     [("constexpr int kVecs = sizeof(T) == 2 ? 2 : 1;",
       "constexpr int kVecs = 4;")]),
]
_THREE = [("constexpr int kLnBwdBlocksPerSm = 2;",
           "constexpr int kLnBwdBlocksPerSm = 3;")]
# (variant, substitutions, row backward blocks an SM)
ROW_VARIANTS = [
    ("as is", [], 2),
    ("no reduction kernel",
     [("  ln_partials_reduce_kernel<TP>\n",
       "  if (rows < 0) ln_partials_reduce_kernel<TP>\n")], 2),
    ("K3 sums in registers", [("kMode == kLnX && NV * E <= kLnRegAccElems",
                               "NV * E <= kLnRegAccElems")], 2),
    ("K4b sums in shared memory", [("constexpr int kLnRegAccElems = 32;",
                                    "constexpr int kLnRegAccElems = 0;")], 2),
    ("3 blocks an SM", _THREE, 3),
    ("row read twice, 3 blocks an SM",
     [("constexpr int kLnHoldElems = 32;", "constexpr int kLnHoldElems = 0;")]
     + _THREE, 3),
    ("reduction of 8 warps", [("constexpr int kLnReduceWarps = 32;",
                               "constexpr int kLnReduceWarps = 8;")], 2),
]


def build(variants, parent):
    """{(variant, stem): library path}: patched copies of csrc (of the
    parent's for the variant "parent"), one nvcc each, all started
    together."""
    from incubator_mxnet_tpu_torch.ops import _build

    jobs = []
    for name, stem, subs in variants:
        src_dir = parent if name == "parent" else _build.CSRC_DIR
        d = OUT / name.replace(" ", "_") / stem
        d.mkdir(parents=True, exist_ok=True)
        for f in list(src_dir.glob("*.cuh")) + [src_dir / f"{stem}.cu"]:
            text = f.read_text()
            for old, new in subs:
                text = text.replace(old, new)
            (d / f.name).write_text(text)
        lib = d / f"{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{stem}.cu")]
        jobs.append(((name, stem), lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = {}
    for key, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed for variant {key}:\n{log}")
        for k, (regs, spills) in sorted(cs._ptxas_report(log).items()):
            label = cs._row_kernel_label(k)
            if label and ("NV=3 " in label or "NV=6 " in label
                          or label.startswith(("K6", "row bwd reduce"))):
                cs.log(f"[ablation] build {key[0]!r} {label}: {regs} "
                       f"registers, {spills} bytes spilled")
        out[key] = lib
    return out


def check_subs(variants):
    """Fail if a substitution's text is missing from the source it
    patches (a variant that silently equals the shipped source)."""
    from incubator_mxnet_tpu_torch.ops import _build

    for name, stem, subs in variants:
        if name == "parent":
            continue
        texts = [f.read_text() for f in [_build.CSRC_DIR / f"{stem}.cu"]
                 + list(_build.CSRC_DIR.glob("*.cuh"))]
        for old, _ in subs:
            if not any(old in t for t in texts):
                cs.fail(f"variant {name!r}: {old!r} not in the sources")


def bind(path, stem):
    # the row entries' dtype codes: x and gamma (LayerNorm), or x, h and
    # gamma (the residual kernels)
    codes = [ctypes.c_int] * (2 if stem == "layer_norm" else 3)
    lib = ctypes.CDLL(str(path))
    if stem == "gelu_dropout":
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                ctypes.c_void_p]
        lib.mx_gelu_dropout_fwd.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 2 + tail
        lib.mx_gelu_dropout_bwd.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 3 + tail
    elif stem == "layer_norm":
        lib.mx_layer_norm_bwd.argtypes = (codes + [ctypes.c_void_p] * 8
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
    else:
        lib.mx_residual_dropout_ln_bwd.argtypes = (
            codes + [ctypes.c_int] + [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 3
            + [ctypes.c_float, ctypes.c_void_p])
    return lib


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device is available",
              file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        parent = parent / "incubator_mxnet_tpu_torch" / "csrc"
    dev = torch.device("cuda", 0)
    sms = ln.sm_count(dev)
    variants = list(K6_VARIANTS)
    for stem in ("layer_norm", "fused_block"):
        variants += [(n, stem, subs) for n, subs, _ in ROW_VARIANTS]
    per_sm = {n: k for n, _, k in ROW_VARIANTS}
    check_subs(variants)
    if parent is not None:
        variants += [("parent", stem, []) for stem in
                     ("gelu_dropout", "layer_norm", "fused_block")]
    t0 = time.perf_counter()
    libs = {k: bind(p, k[1]) for k, p in build(variants, parent).items()}
    cs.log(f"[ablation] built {len(libs)} variant libraries in "
           f"{time.perf_counter() - t0:.1f} s")
    def stream():  # the capturing stream inside a CUDA graph
        return torch.cuda.current_stream().cuda_stream

    codes = {torch.float32: 0, torch.bfloat16: 1}
    results = []

    def turns(names, case, fns, bound_ms):
        # one discarded round first: the first timings of a case read
        # slower than the same code timed later
        for n in names:
            cs.time_ms(*fns[n], 20)
        order = names + names[::-1]
        ms = {n: [] for n in names}
        for n in order:
            fn, sets = fns[n]
            ms[n].append(cs.time_ms(fn, sets, 20))
        base = sum(ms["as is"]) / 2
        for n in names:
            t = sum(ms[n]) / 2
            cs.log(f"[ablation] {case} {n}: {t:.4f} ms ({ms[n][0]:.4f}, "
                   f"{ms[n][1]:.4f}); as is - this {base - t:+.4f} ms; "
                   f"bound {bound_ms:.4f} ms")
            results.append(dict(case=case, variant=n, ms=t, runs=ms[n],
                                bound_ms=bound_ms))

    # K6
    key, p = (1618033988, 2718281828), cs.TRAIN_P
    k6_names = [n for n, stem, _ in variants if stem == "gelu_dropout"]
    for shape, dtype, pp in [((cs.ROWS, cs.FFN), torch.float32, p),
                             ((cs.ROWS, cs.FFN), torch.float32, 0.0),
                             ((cs.ROWS, cs.FFN), torch.bfloat16, p),
                             ((cs.ROWS, cs.FFN), torch.bfloat16, 0.0),
                             (cs.GD_LARGE, torch.bfloat16, p)]:
        g = torch.Generator(device=dev).manual_seed(shape[0] + shape[1])
        u = torch.randn(*shape, generator=g, device=dev).to(dtype)
        dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        n, item = u.numel(), u.element_size()
        kargs = ((int(pp > 0), key[0], key[1], ph.threshold(pp),
                  ph.dropout_scale(pp)) if pp > 0 else (0, 0, 0, 0, 1.0))
        for bwd in (False, True):
            fns = {}
            for name in k6_names:
                lib = libs[(name, "gelu_dropout")]
                if bwd:
                    sets = cs.input_sets([u, dy, torch.empty_like(u)], 20)
                    fns[name] = (lambda a, b, o, lib=lib: lib.
                                 mx_gelu_dropout_bwd(
                                     codes[dtype], a.data_ptr(), b.data_ptr(),
                                     o.data_ptr(), n, *kargs, stream()), sets)
                else:
                    sets = cs.input_sets([u, torch.empty_like(u)], 20)
                    fns[name] = (lambda a, o, lib=lib: lib.
                                 mx_gelu_dropout_fwd(
                                     codes[dtype], a.data_ptr(), o.data_ptr(),
                                     n, *kargs, stream()), sets)
            bound_ms = cs.bound((3 if bwd else 2) * n * item,
                                (cs.GD_BWD_OPS if bwd else cs.GD_FWD_OPS) * n,
                                "float32")[0]
            turns(k6_names, f"K6 {'bwd' if bwd else 'fwd'} {shape} "
                  f"{cs._dt(dtype)} p={pp}", fns, bound_ms)

    # the row backward: K4b and K3's backward at the training step's rows
    for stem, dtype, pp in [("layer_norm", torch.float32, None),
                            ("layer_norm", torch.bfloat16, None),
                            ("fused_block", torch.float32, p),
                            ("fused_block", torch.float32, 0.0),
                            ("fused_block", torch.bfloat16, p)]:
        rows, cols = cs.ROWS, cs.C
        g = torch.Generator(device=dev).manual_seed(17)
        x, h, dy = (torch.randn(rows, cols, generator=g, device=dev).to(dtype)
                    for _ in range(3))
        gamma = (1 + 0.3 * torch.randn(cols, generator=g, device=dev)).to(
            dtype)
        mean = x.float().mean(1)
        rstd = torch.rsqrt(x.float().var(1, unbiased=False) + 1e-5)
        item = x.element_size()
        names = [n for n, st, _ in variants if st == stem]
        fns = {}
        dt_args = (codes[dtype],) * (2 if stem == "layer_norm" else 3)
        for name in names:
            lib = libs[(name, stem)]
            if name == "parent":  # its grid, f32 dgamma/dbeta, two casts
                nb = max(1, min(-(-rows // 8), 512))
                dgb_dtype, cast = torch.float32, dtype != torch.float32
            else:
                nb = max(1, min(-(-rows // 8), per_sm[name] * sms))
                dgb_dtype, cast = dtype, False
            part = torch.empty((nb, 2, cols), device=dev)
            dgb = torch.empty((2, cols), dtype=dgb_dtype, device=dev)
            dx, dh = torch.empty_like(x), torch.empty_like(x)
            if stem == "layer_norm":
                sets = cs.input_sets([x, dy], 20)

                def fn(a, b, lib=lib, nb=nb, part=part, dgb=dgb, cast=cast,
                       dt_args=dt_args):
                    lib.mx_layer_norm_bwd(
                        *dt_args, a.data_ptr(), b.data_ptr(),
                        mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
                        dx.data_ptr(), part.data_ptr(), dgb.data_ptr(), rows,
                        cols, nb, stream())
                    if cast:
                        dgb[0].to(dtype), dgb[1].to(dtype)
            else:
                sets = cs.input_sets([x, h, dy], 20)
                mode_args = ((2, key[0], key[1], ph.threshold(pp),
                              ph.dropout_scale(pp)) if pp > 0
                             else (1, 0, 0, 0, 1.0))

                def fn(a, hh, b, lib=lib, nb=nb, part=part, dgb=dgb,
                       cast=cast, mode_args=mode_args, dt_args=dt_args):
                    mode, *kargs = mode_args
                    lib.mx_residual_dropout_ln_bwd(
                        *dt_args, mode, a.data_ptr(), hh.data_ptr(),
                        b.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                        gamma.data_ptr(), dx.data_ptr(), dh.data_ptr(),
                        part.data_ptr(), dgb.data_ptr(), rows, cols, nb,
                        *kargs, stream())
                    if cast:
                        dgb[0].to(dtype), dgb[1].to(dtype)
            fns[name] = (fn, sets)
        n_arrays = 3 if stem == "layer_norm" else 5
        bound_ms = cs.bound(n_arrays * rows * cols * item + 8 * rows,
                            (12 if stem == "layer_norm" else 16) * rows * cols,
                            cs._dt(dtype))[0]
        kind = "K4b" if stem == "layer_norm" else f"K3 bwd p={pp}"
        turns(names, f"{kind} ({rows}, {cols}) {cs._dt(dtype)}", fns,
              bound_ms)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    line = json.dumps({"ablation": results, "device": smi})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ablation.json").write_text(line + "\n")
    cs.log(line)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
