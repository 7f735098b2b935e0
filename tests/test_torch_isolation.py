"""The port stands alone: it imports neither jax nor the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import incubator_mxnet_tpu_torch

PKG = Path(incubator_mxnet_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_import_in_source():
    found = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not found, found


def test_runtime_imports_stay_isolated():
    """A fresh interpreter builds and runs a tiny GPT on the CPU without
    loading jax or the reference package."""
    code = (
        "import sys, torch\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch.models import gpt_tiny\n"
        "m = gpt_tiny(vocab_size=50, max_length=32, dropout=0.0,"
        " device='cpu', seed=0)\n"
        "out = m.generate(torch.zeros((1, 3), dtype=torch.long), 4)\n"
        "assert out.shape == (1, 7)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


SERVING_PLANE = ("telemetry.locks", "telemetry.tracing", "telemetry.capacity",
                 "telemetry.anatomy", "telemetry.slo", "fault",
                 "fault.injection", "fault.retry", "serve.tenancy",
                 "serve.router", "serve.gateway", "serve.disagg")


def test_serving_plane_modules_stand_alone():
    """Every module of the serving plane (telemetry, fault, tenancy,
    routing, gateway, disaggregation) imports alone in a fresh
    interpreter, and a gateway over a disaggregated tiny GPT serves a
    traced request on the CPU, without loading jax or the reference
    package; `serve.tenancy` imports nothing of the package at all."""
    tenancy = PKG / "serve" / "tenancy.py"
    rel = [n for n in ast.walk(ast.parse(tenancy.read_text()))
           if isinstance(n, ast.ImportFrom) and n.level > 0]
    assert not rel, "serve/tenancy.py imports from the package"
    code = (
        "import importlib, sys\n"
        f"for m in {SERVING_PLANE!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "from incubator_mxnet_tpu_torch import serve\n"
        "from incubator_mxnet_tpu_torch.models import gpt_tiny\n"
        "from incubator_mxnet_tpu_torch.telemetry import tracing\n"
        "tracing.enable()\n"
        "m = gpt_tiny(vocab_size=50, max_length=32, dropout=0.0,"
        " device='cpu', seed=0)\n"
        "reg = serve.ModelRegistry(total_pages=24)\n"
        "reg.add('g', m, prefill_replicas=1, decode_replicas=1,"
        " max_slots=2, max_len=32)\n"
        "gw = serve.Gateway(reg)\n"
        "out = gw.generate('g', list(range(5)), 3, tenant='t')\n"
        "assert out.shape == (8,)\n"
        "assert tracing.finished_spans()\n"
        "gw.shutdown()\n"
        "bad = [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


OBSERVATORY_AND_ELASTIC = ("telemetry.timeseries", "telemetry.burnrate",
                           "telemetry.goodput", "telemetry.hbm",
                           "telemetry.compiles", "serve.advisor",
                           "serve.elastic")


def test_observatory_and_elastic_modules_stand_alone():
    """The seven modules of the serving plane's history, budgets and
    control (timeseries, burn rate, goodput, the device-memory census,
    the program ledger, the advisor, the elastic controller) import
    alone in a fresh interpreter, each without loading jax or the
    reference package; then an elastic gateway over a tiny GPT, with the
    sampler, the census and the ledger armed, scales up on the CPU and
    serves, still without them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {OBSERVATORY_AND_ELASTIC!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "from incubator_mxnet_tpu_torch import serve\n"
        "from incubator_mxnet_tpu_torch.models import gpt_tiny\n"
        "from incubator_mxnet_tpu_torch.telemetry import (compiles, hbm,"
        " timeseries)\n"
        "compiles.enable(); hbm.enable()\n"
        "timeseries.enable(interval_s=0.05, samples=64)\n"
        "m = gpt_tiny(vocab_size=50, max_length=32, dropout=0.0,"
        " device='cpu', seed=0)\n"
        "reg = serve.ModelRegistry(total_pages=24)\n"
        "reg.add('g', m, max_slots=2, max_len=32)\n"
        "gw = serve.Gateway(reg)\n"
        "ctl = gw.enable_elastic(max_replicas=2, warm_lens=(5,))\n"
        "assert [r.label for r in ctl.scale_up('g')] == ['g#1']\n"
        "out = gw.generate('g', list(range(5)), 3, tenant='t')\n"
        "assert out.shape == (8,)\n"
        "assert 'serve:g#1.decode' in compiles.ledger()\n"
        "assert hbm.census(top_k=0)['owners']['serve:g#1.kv_pool'] > 0\n"
        "gw.shutdown()\n"
        "timeseries.disable()\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


NDARRAY_SLICE = ("base", "device", "autograd", "_tnp", "ndarray",
                 "ndarray.ndarray", "numpy", "numpy.random", "dlpack",
                 "test_utils", "numpy_extension")


def test_ndarray_slice_modules_stand_alone():
    """The NDArray slice's modules (NDArray and its funnel, `mx.np`,
    `mx.nd`, `autograd`, `dlpack`, `test_utils`) import alone in a fresh
    interpreter, each without loading jax or the reference package; then
    the reference's imperative user code runs on the CPU, still without
    them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {NDARRAY_SLICE!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import np, npx, autograd\n"
        "with mx.cpu():\n"
        "    x = np.random.uniform(size=(4, 8))\n"
        "    w = np.array([[0.5] * 3] * 8)\n"
        "    x.attach_grad()\n"
        "    with autograd.record():\n"
        "        y = npx.layer_norm(np.dot(x, w), np.ones(3), np.zeros(3))\n"
        "        loss = npx.dropout(y, p=0.1).sum()\n"
        "    loss.backward()\n"
        "    assert x.grad.shape == (4, 8)\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
