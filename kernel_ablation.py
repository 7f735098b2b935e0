#!/usr/bin/env python3
"""Time variants of the port's K6 (fused GELU + dropout), row-backward
(K4b, K3 backward) and forward row (K4, K3 forward) kernels on one CUDA
card, in one run.

Run from the root of a checkout: ``python3 kernel_ablation.py [--parent
DIR] [--only fwd,bwd,k6,host]``. A variant is the source of
``incubator_mxnet_tpu_torch/csrc`` with named text substitutions: a part
of the work taken out (the normal tail's rational function, Philox, the
dgamma/dbeta reduction) or a design choice changed (erff for the tail,
Philox's multiplies, vectors a thread; where the row backward keeps its
row and its sums, blocks an SM, the reduction's warps; the forward's
gamma/beta held in registers, its next row in flight, its exact vector
count, its streaming loads, K3's Philox words, how K3 takes gamma/beta).
A row-backward variant runs on its own grid (blocks an SM x SMs);
a forward grid variant is the shipped library on another number of
blocks than `ops.layer_norm.row_blocks`'s. Each source variant is built by ``nvcc``
with the port's flags into ``build/ablation/<variant>/``. ``--parent
DIR`` adds the sources of another checkout's
``incubator_mxnet_tpu_torch/csrc`` (the parent commit, unpacked with
``git archive``) as the variant "parent", called as its own wrappers call
it, and (section "host") times the parent's Python LayerNorm-forward
wrapper against this one's, host microseconds a call. Every variant's C
entry is called directly on the same inputs: one discarded round, then in
turns (the variants in order, then in reverse), timed as
``chip_smoke.py`` times kernels (CUDA events over CUDA-graph replays
whose inputs cycle beyond the L2 cache; in the forward cases past 64
rows y and the statistics cycle too, so every write reaches device
memory as the bound counts; at up to 64 rows gamma and beta cycle
instead, so every call finds them cold, as a decode replay does).
``--only`` runs the named sections (default: all). Prints one line per
case and variant, the card's name and power limit, then one JSON line
(also written to ``chiprun_out/kernel_ablation.json``). A variant without
the work it names computes a wrong result: only its time means anything.
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


# the forward row kernels: each part of the design (common.cuh) taken out
# or set the other way, on the shipped grid
_K3_IN_PLACE = [("  constexpr bool kHold = NV * E <= kLnFwdHoldElems;",
                 "  constexpr bool kHold = NV * E <= kLnFwdHoldElems && "
                 "kMode == kLnX;")]
_PARAMS = "  constexpr bool kParams = kHold && kMode == kLnX;"
# 4-warp blocks, one row a warp, no floor on blocks an SM (the parent's)
_PARENT_GRID = [("__launch_bounds__(kLnFwdWarps * 32,", "__launch_bounds__(128,"),
                ("? kLnFwdBlocksPerSm", "? 1"),
                ("      <<<blocks, kLnFwdWarps * 32, 0, stream>>>(",
                 "      <<<blocks, 128, 0, stream>>>(")]
FWD_VARIANTS = [
    ("as is", []),
    ("gamma and beta after the reductions",
     [(_PARAMS, "  constexpr bool kParams = false;")]),
    ("no next row in flight",  # the row's loads issued at its own turn
     [("      if (next < rows)\n        ln_fwd_issue",
       "      if (next < 0)\n        ln_fwd_issue"),
      ("    row = next;\n    if (row >= rows) break;\n",
       "    row = next;\n    if (row >= rows) break;\n    if constexpr "
       "(kHold)\n      ln_fwd_issue<TX, TH, NV, NH, kMode>(x, h, row, cols, "
       "lane, key, xr, hr, keep);\n")]),
    ("NV a power of two",
     [(f"    case {n}: MX_LN_FWD({n});", f"    case {n}: MX_LN_FWD({p2});")
      for n, p2 in ((3, 4), (5, 8), (6, 8), (7, 8))]
     + [("  if (nv <= 12) MX_LN_FWD(12);", "  if (nv <= 12) MX_LN_FWD(16);"),
        ("    if (nv <= 24) MX_LN_FWD(24);",
         "    if (nv <= 24) MX_LN_FWD(32);")]),
    ("K3 holds gamma and beta", [(_PARAMS, "  constexpr bool kParams = kHold;")]),
    ("K3 loads in place, one row a warp", _K3_IN_PLACE),
    ("the next row's Philox words after the stores",
     [("        ln_fwd_issue<TX, TH, NV, NH, kMode>(x, h, next, cols, lane, "
       "key, xr,\n                                            hr, keep);",
       "        ln_fwd_issue<TX, TH, NV, NH, kLnXPlusH>(x, h, next, cols, "
       "lane, key,\n                                            xr, hr, "
       "keep);"),
      ("    if (lane == 0) {\n      mean_out[row] = mean;\n      "
       "rstd_out[row] = rstd;\n    }\n    row = next;",
       "    if (lane == 0) {\n      mean_out[row] = mean;\n      "
       "rstd_out[row] = rstd;\n    }\n    if constexpr (kHold && kMode == "
       "kLnXPlusDropH) {\n      if (next < rows) ln_fwd_keep<TX, NV>(next, "
       "cols, lane, key, keep);\n    }\n    row = next;")]),
    ("K4 x loaded plainly",
     [("kMode == kLnX || sizeof(TX) == 2 ? kCacheStream",
       "kMode != kLnX && sizeof(TX) == 2 ? kCacheStream")]),
    ("K3 x and h loaded the other way (f32 x streamed, bf16 plainly)",
     [("kMode == kLnX || sizeof(TX) == 2 ? kCacheStream",
       "kMode == kLnX || sizeof(TX) == 4 ? kCacheStream")]),
    ("K3 loads in place, 3 blocks an SM",
     _K3_IN_PLACE + [("? kLnFwdBlocksPerSm", "? 3")]),
    ("K3 3 blocks an SM", [("? kLnFwdBlocksPerSm", "? 3")]),
    ("K3 on the parent's grid, loads in place",
     _K3_IN_PLACE + _PARENT_GRID),
    ("K3 on the parent's grid", _PARENT_GRID),
    ("K4 one single-warp block a row",  # on FWD_VARIANT_GRIDS' grid
     [("      <<<blocks, kLnFwdWarps * 32, 0, stream>>>(",
       "      <<<blocks, 32, 0, stream>>>(")]),
]
# the grids of the source variants that take their own (rows, sms) ->
# 8-warp blocks; the others run on `row_blocks`'
FWD_VARIANT_GRIDS = {
    "K3 loads in place, one row a warp": lambda rows, sms: -(-rows // 8),
    "K4 one single-warp block a row": lambda rows, sms: rows,
    "K3 loads in place, 3 blocks an SM":
        lambda rows, sms: min(-(-rows // 8), 3 * sms),
    "K3 3 blocks an SM": lambda rows, sms: min(-(-rows // 8), 3 * sms),
    "K3 on the parent's grid, loads in place": lambda rows, sms: -(-rows // 4),
    "K3 on the parent's grid": lambda rows, sms: -(-rows // 4),
}
# the shipped forward on other grids of 8-warp blocks: (variant, (rows,
# sms) -> blocks)
FWD_GRIDS = [
    ("one row a warp", lambda rows, sms: -(-rows // 8)),
    ("walk, 2 rows a warp", lambda rows, sms: max(1, -(-rows // 16))),
    ("walk, 1 block an SM", lambda rows, sms: min(-(-rows // 8), sms)),
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
                          or label.startswith(("K6", "row bwd reduce"))) \
                    and (key[1] == "gelu_dropout") == label.startswith(
                        "K6"):
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


def bind(path, stem, parent=False):
    # the row entries' dtype codes: x and gamma (LayerNorm), or x, h and
    # gamma (the residual kernels); the forward entries end in the grid
    # (blocks), but for the parent's
    codes = [ctypes.c_int] * (2 if stem == "layer_norm" else 3)
    grid = [] if parent else [ctypes.c_int]
    lib = ctypes.CDLL(str(path))
    if stem == "layer_norm":
        lib.mx_layer_norm_fwd.argtypes = (
            codes + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_float] + grid + [ctypes.c_void_p])
    elif stem == "fused_block":
        lib.mx_residual_dropout_ln_fwd.argtypes = (
            codes + [ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_uint32] * 3
            + [ctypes.c_float] + grid + [ctypes.c_void_p])
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


SECTIONS = ("k6", "bwd", "fwd", "host")
# rounds of (this wrapper, the parent's, the parent's, this one) in the
# host section, each `chip_smoke.wrapper_host_us` (the least of 7 batches)
HOST_ROUNDS = 4
# the forward's cases: K4 at the main paths' rows (8: the decode; 64: a
# prefill chunk; 800-2000: GPTDecoder's prefills; 8192: the BERT-base
# step), K3 at the step's rows
FWD_K4_ROWS = (1, 8, 64, 800, 1000, 2000, cs.ROWS)


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device is available",
              file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        parent = parent / "incubator_mxnet_tpu_torch" / "csrc"
    sections = set(SECTIONS)
    if "--only" in sys.argv:
        sections = set(sys.argv[sys.argv.index("--only") + 1].split(","))
        if not sections <= set(SECTIONS):
            cs.fail(f"--only takes {','.join(SECTIONS)}")
    if "host" in sections and parent is None:
        cs.fail("the host section times the parent's wrapper: --parent")
    dev = torch.device("cuda", 0)
    sms = ln.sm_count(dev)
    variants, stems = [], set()
    if "k6" in sections:
        variants += K6_VARIANTS
        stems.add("gelu_dropout")
    if "bwd" in sections:
        for stem in ("layer_norm", "fused_block"):
            variants += [(n, stem, subs) for n, subs, _ in ROW_VARIANTS]
    if sections & {"bwd", "fwd", "host"}:
        stems |= {"layer_norm", "fused_block"}
    if "fwd" in sections:
        for stem in ("layer_norm", "fused_block"):
            # a variant named "K3 ..." (or of K3's Philox words) is K3's
            # alone, one named "K4 ..." K4's
            variants += [(n, stem, subs) for n, subs in FWD_VARIANTS
                         if (not n.startswith("K4") if stem == "fused_block"
                             else not n.startswith("K3")
                             and "Philox" not in n)
                         and (n, stem) not in {v[:2] for v in variants}]
    per_sm = {n: k for n, _, k in ROW_VARIANTS}
    check_subs(variants)
    if parent is not None:
        variants += [("parent", stem, []) for stem in sorted(stems)]
    t0 = time.perf_counter()
    paths = build(variants, parent)
    libs = {k: bind(p, k[1], k[0] == "parent") for k, p in paths.items()}
    cs.log(f"[ablation] built {len(libs)} variant libraries in "
           f"{time.perf_counter() - t0:.1f} s")
    def stream():  # the capturing stream inside a CUDA graph
        return torch.cuda.current_stream().cuda_stream

    codes = {torch.float32: 0, torch.bfloat16: 1}
    results = []

    def turns(names, case, fns, bound_ms, reps=20):
        # one discarded round first: the first timings of a case read
        # slower than the same code timed later
        for n in names:
            cs.time_ms(*fns[n], reps)
        order = names + names[::-1]
        ms = {n: [] for n in names}
        for n in order:
            fn, sets = fns[n]
            ms[n].append(cs.time_ms(fn, sets, reps))
        base = sum(ms["as is"]) / 2
        for n in names:
            t = sum(ms[n]) / 2
            cs.log(f"[ablation] {case} {n}: {t:.4f} ms ({ms[n][0]:.4f}, "
                   f"{ms[n][1]:.4f}); as is - this {base - t:+.4f} ms; "
                   f"bound {bound_ms:.4f} ms")
            results.append(dict(case=case, variant=n, ms=t, runs=ms[n],
                                bound_ms=bound_ms))

    if "k6" in sections:
        k6_section(torch, dev, variants, libs, turns, stream, codes)
    if "bwd" in sections:
        bwd_section(torch, dev, variants, libs, turns, stream, codes,
                    per_sm, sms)
    if "fwd" in sections:
        fwd_section(torch, dev, variants, libs, turns, stream, codes, sms)
    if "host" in sections:
        results += host_section(torch, dev, parent, paths)

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


def k6_section(torch, dev, variants, libs, turns, stream, codes):
    from incubator_mxnet_tpu_torch.ops import _philox as ph

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


def bwd_section(torch, dev, variants, libs, turns, stream, codes, per_sm,
                sms):
    from incubator_mxnet_tpu_torch.ops import _philox as ph

    key, p = (1618033988, 2718281828), cs.TRAIN_P

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
        names = [n for n, st, _ in variants if st == stem
                 and (n in per_sm or n == "parent")]
        fns = {}
        dt_args = (codes[dtype],) * (2 if stem == "layer_norm" else 3)
        for name in names:
            lib = libs[(name, stem)]
            # the parent's backward is this one's (its grid, its entry)
            nb = max(1, min(-(-rows // 8), per_sm.get(name, 2) * sms))
            part = torch.empty((nb, 2, cols), device=dev)
            dgb = torch.empty((2, cols), dtype=dtype, device=dev)
            dx, dh = torch.empty_like(x), torch.empty_like(x)
            if stem == "layer_norm":
                sets = cs.input_sets([x, dy], 20)

                def fn(a, b, lib=lib, nb=nb, part=part, dgb=dgb,
                       dt_args=dt_args):
                    lib.mx_layer_norm_bwd(
                        *dt_args, a.data_ptr(), b.data_ptr(),
                        mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
                        dx.data_ptr(), part.data_ptr(), dgb.data_ptr(), rows,
                        cols, nb, stream())
            else:
                sets = cs.input_sets([x, h, dy], 20)
                mode_args = ((2, key[0], key[1], ph.threshold(pp),
                              ph.dropout_scale(pp)) if pp > 0
                             else (1, 0, 0, 0, 1.0))

                def fn(a, hh, b, lib=lib, nb=nb, part=part, dgb=dgb,
                       mode_args=mode_args, dt_args=dt_args):
                    mode, *kargs = mode_args
                    lib.mx_residual_dropout_ln_bwd(
                        *dt_args, mode, a.data_ptr(), hh.data_ptr(),
                        b.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                        gamma.data_ptr(), dx.data_ptr(), dh.data_ptr(),
                        part.data_ptr(), dgb.data_ptr(), rows, cols, nb,
                        *kargs, stream())
            fns[name] = (fn, sets)
        n_arrays = 3 if stem == "layer_norm" else 5
        bound_ms = cs.bound(n_arrays * rows * cols * item + 8 * rows,
                            (12 if stem == "layer_norm" else 16) * rows * cols,
                            cs._dt(dtype))[0]
        kind = "K4b" if stem == "layer_norm" else f"K3 bwd p={pp}"
        turns(names, f"{kind} ({rows}, {cols}) {cs._dt(dtype)}", fns,
              bound_ms)


def fwd_section(torch, dev, variants, libs, turns, stream, codes, sms):
    """K4 at FWD_K4_ROWS (f32, and AMP's bf16 x with f32 gamma/beta) and
    K3 forward at the step's rows (p = 0.1; f32, bf16, and AMP's f32 x
    with bf16 h): each source variant on the shipped grid, the parent's
    kernel on its own grid, the shipped kernel on the other grids of
    FWD_GRIDS."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    key, p = (1618033988, 2718281828), cs.TRAIN_P
    src_names = [n for n, _ in FWD_VARIANTS] + ["parent"]
    grids = dict(FWD_GRIDS)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("layer_norm", xdt, None, pdt, rows) for xdt, pdt in
             ((f32, f32), (bf16, f32)) for rows in FWD_K4_ROWS]
    cases += [("fused_block", xdt, hdt, pdt, cs.ROWS) for xdt, hdt, pdt in
              ((f32, f32, f32), (bf16, bf16, bf16), (f32, bf16, f32))]
    C = cs.C
    for stem, xdt, hdt, pdt, rows in cases:
        g = torch.Generator(device=dev).manual_seed(rows)
        x = (torch.randn(rows, C, generator=g, device=dev) * 2 + 0.5).to(xdt)
        gamma = (1 + 0.3 * torch.randn(C, generator=g, device=dev)).to(pdt)
        beta = (0.3 * torch.randn(C, generator=g, device=dev)).to(pdt)
        h = (None if hdt is None else
             torch.randn(rows, C, generator=g, device=dev).to(hdt))
        y = torch.empty_like(x)
        stats = torch.empty((2, rows), device=dev)
        cold = rows <= cs.COLD_LN_ROWS
        ins = [x] + ([] if h is None else [h])
        # a set: (x, [h,] gamma, beta, y, stats)
        if cold:  # gamma and beta cold, as in a decode replay
            sets = [(*t, y, stats) for t in cs.cold_sets(ins + [gamma, beta])]
        else:     # y and the statistics written to device memory
            sets = [(*t[:-2], gamma, beta, *t[-2:])
                    for t in cs.input_sets(ins + [y, stats], 20)]
        reps = len(sets) if cold else 20
        names = [n for n, st, _ in variants
                 if st == stem and n in src_names] + list(grids)
        shipped = ln.row_blocks(rows, sms)
        fns = {}
        for name in names:
            if name in grids:
                lib, grid = libs[("as is", stem)], (grids[name](rows, sms),)
            else:
                lib = libs[(name, stem)]
                grid = (() if name == "parent" else
                        (FWD_VARIANT_GRIDS[name](rows, sms),)
                        if name in FWD_VARIANT_GRIDS else (shipped,))
            if stem == "layer_norm":
                def fn(a, gg, bb, yy, st, lib=lib, grid=grid):
                    lib.mx_layer_norm_fwd(
                        codes[xdt], codes[pdt], a.data_ptr(), gg.data_ptr(),
                        bb.data_ptr(), yy.data_ptr(), st.data_ptr(),
                        st[1].data_ptr(), rows, C, 1e-5, *grid, stream())
            else:
                def fn(a, hh, gg, bb, yy, st, lib=lib, grid=grid):
                    lib.mx_residual_dropout_ln_fwd(
                        codes[xdt], codes[hdt], codes[pdt], 2, a.data_ptr(),
                        hh.data_ptr(), gg.data_ptr(), bb.data_ptr(),
                        yy.data_ptr(), st.data_ptr(), st[1].data_ptr(),
                        rows, C, 1e-5, key[0], key[1], ph.threshold(p),
                        ph.dropout_scale(p), *grid, stream())
            fns[name] = (fn, sets)
        ix, ip = x.element_size(), gamma.element_size()
        ih = 0 if h is None else h.element_size()
        ops_dt = cs._dt(xdt) if len({xdt, hdt or xdt, pdt}) == 1 \
            else "float32"
        bound_ms = cs.bound((2 * ix + ih) * rows * C + 8 * rows
                            + 2 * C * ip, (8 if h is None else 10) * rows * C,
                            ops_dt)[0]
        layout = ln.layout_name(xdt, pdt, hdt)
        kind = "K4" if h is None else f"K3 fwd p={p}"
        turns(names, f"{kind} ({rows}, {C}) {layout}"
              + (" cold" if cold else " y cycled"), fns, bound_ms, reps)


def _enter_exit(ctx):
    with ctx:
        pass


def host_section(torch, dev, parent, paths):
    """Host us a call of the LayerNorm forward's Python wrapper, the
    parent's against this one's, in turns, at the decode's (8, 768) f32;
    and this wrapper's parts, each alone."""
    import importlib
    import types

    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln

    pkg = types.ModuleType("parent_port")
    pkg.__path__ = [str(parent.parent)]
    sys.modules["parent_port"] = pkg
    pbuild = importlib.import_module("parent_port.ops._build")

    def load(stem):
        lib = ctypes.CDLL(str(paths[("parent", stem)]))
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        return lib

    pbuild.load = load
    pln = importlib.import_module("parent_port.ops.layer_norm")
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(cs.N, cs.C, generator=g, device=dev)
    gamma = 1 + 0.3 * torch.randn(cs.C, generator=g, device=dev)
    beta = 0.3 * torch.randn(cs.C, generator=g, device=dev)
    wrappers = {"as is": lambda: ln.layer_norm_fwd(x, gamma, beta),
                "parent": lambda: pln.layer_norm_fwd(x, gamma, beta)}
    same = all(torch.equal(a, b) for a, b in zip(wrappers["as is"](),
                                                 wrappers["parent"]()))
    us = {n: [] for n in wrappers}
    for _ in range(HOST_ROUNDS):
        for n in ["as is", "parent", "parent", "as is"]:
            us[n].append(cs.wrapper_host_us(torch, wrappers[n]))
    out = []
    for n, v in us.items():
        med = sorted(v)[len(v) // 2]
        cs.log(f"[ablation] host: layer_norm_fwd ({cs.N}, {cs.C}) f32, "
               f"{n}: least {min(v):.2f} us a call, median {med:.2f} "
               f"({', '.join(f'{t:.2f}' for t in v)})")
        out.append(dict(case=f"host us a call, layer_norm_fwd ({cs.N}, "
                        f"{cs.C}) f32", variant=n, us=min(v), median_us=med,
                        runs=v))
    cs.log(f"[ablation] host: the two wrappers' y, mean and rstd equal bit "
           f"for bit: {same}")
    y = torch.empty_like(x)
    stats = torch.empty((2, cs.N), device=dev)
    lib = ln._lib()
    parts = {
        "check_kernel_args": lambda: ln.check_kernel_args(
            "layer_norm", x, (gamma, beta)),
        "aligned x3": lambda: [_build.aligned(t) for t in (x, gamma, beta)],
        "empty_like + stats": lambda: (torch.empty_like(x), torch.empty(
            (2, cs.N), dtype=torch.float32, device=dev)),
        "row_blocks + sm_count": lambda: ln.row_blocks(
            cs.N, ln.sm_count(dev)),
        "stream_of": lambda: _build.stream_of(dev),
        "on_device enter/exit": lambda: _enter_exit(_build.on_device(dev)),
        "torch.cuda.device enter/exit": lambda: _enter_exit(
            torch.cuda.device(dev)),
        "data_ptr x6": lambda: [t.data_ptr() for t in
                                (x, gamma, beta, y, stats, stats)],
        "the C entry": lambda: lib.mx_layer_norm_fwd(
            0, 0, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), stats.data_ptr(), stats[1].data_ptr(), cs.N, cs.C,
            1e-5, 1, _build.stream_of(dev)),
        "layout_launches += 1": lambda: ln.layout_launches.__setitem__(
            "f32", ln.layout_launches["f32"] + 1),
    }
    for name, fn in parts.items():
        t = cs.wrapper_host_us(torch, fn)
        cs.log(f"[ablation] host: {name}: {t:.2f} us")
        out.append(dict(case="host us, a part of layer_norm_fwd", variant=name,
                        us=t))
    return out


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
