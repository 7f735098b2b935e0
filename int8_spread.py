#!/usr/bin/env python3
"""Run-to-run spread of the int8 KV pool's agreement with the f32 engine on
one CUDA card.

Run from the root of a checkout: ``python3 int8_spread.py [--runs N]``. It
serves `chip_smoke.py`'s trace A (bench.py's `bench_gpt_serve` arrivals)
with `gpt2_small` through the f32 engine (`chip_smoke.phase_serve_engine`),
then through the int8 engine ``--runs`` times (`_serve_spec_run`, the
int8 run of `phase_serve_spec`, every check of it but the prefix bar,
which is reported rather than enforced), and ``--runs`` times more with
a variant of the int8 token write that takes a page's scale fresh when
decode writes the page's first token (offset 0), as a prefill chunk's
pages are, instead of growing the scale the page's previous owner left.
The last line is a JSON object: the divergence-free prefix share of each
run, for the port's write and for the variant.
"""
import argparse
import json
import sys

import numpy as onp
import torch

import chip_smoke as cs
from incubator_mxnet_tpu_torch.serve import engine as eng


def fresh_page_scale(write):
    """``SlotDecoder._write_token`` with a page's scale zeroed before the
    write of its first token."""
    def write_token(self, pool, scale, wpage, woff, t):
        if scale is not None:
            scale[wpage] = torch.where((woff == 0)[:, None], 0.0,
                                       scale[wpage])
        return write(self, pool, scale, wpage, woff, t)
    return write_token


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_spread: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.INT8_PREFIX_SHARE = 0.0          # report the share, do not gate it
    _, _, base = cs.phase_serve_engine(torch, dev)
    trace = cs._serve_trace_a(onp)
    shares = {}
    for name in ("grow_only", "fresh_page_scale"):
        if name == "fresh_page_scale":
            eng.SlotDecoder._write_token = fresh_page_scale(
                eng.SlotDecoder._write_token)
        shares[name] = [cs._serve_spec_run(
            torch, dev, f"int8 {name} {i}", dict(kv_dtype="int8"), trace,
            base)[0]["divergence_free_prefix"] for i in range(args.runs)]
    print(json.dumps({"divergence_free_prefix": shares,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
