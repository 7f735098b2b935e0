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


GLUON_SLICE = ("initializer", "lr_scheduler", "preemption", "_graphs",
               "gluon.parameter", "gluon.block", "gluon.nn.basic_layers",
               "gluon.nn.activations", "gluon.nn", "gluon.loss",
               "gluon.trainer", "gluon.utils", "gluon", "optimizer",
               "optimizer.optimizer", "models.params", "models.bert",
               "models.gpt", "parallel.sharded", "amp")


def test_gluon_slice_modules_stand_alone():
    """The gluon slice's modules (Parameter, Block and HybridBlock, the
    layers, losses, initializers, optimizers, schedulers and Trainer, the
    models as HybridBlocks) import alone in a fresh interpreter, each
    without loading jax or the reference package; then the verify
    script's gluon loop runs on the CPU as written, hybridized, still
    without them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {GLUON_SLICE!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import np, autograd, gluon\n"
        "with mx.cpu():\n"
        "    net = gluon.nn.HybridSequential()\n"
        "    net.add(gluon.nn.Dense(32, activation='relu'),"
        " gluon.nn.Dense(10))\n"
        "    net.initialize(); net.hybridize()\n"
        "    trainer = gluon.Trainer(net.collect_params(), 'adam',"
        " {'learning_rate': 1e-3})\n"
        "    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()\n"
        "    x, y = np.random.uniform(size=(64, 20)),"
        " np.random.randint(0, 10, (64,))\n"
        "    for _ in range(3):\n"
        "        with autograd.record():\n"
        "            loss = loss_fn(net(x), y)\n"
        "        loss.backward(); trainer.step(64)\n"
        "    assert loss.shape == (64,)\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


VISION_SLICE = ("numpy_extension._contrib_misc", "numpy_extension._spatial",
                "gluon.nn.conv_layers", "gluon.nn.extra_layers",
                "gluon.model_zoo.model_store", "gluon.model_zoo.vision",
                "gluon.model_zoo.vision.resnet", "gluon.model_zoo.vision.vgg",
                "gluon.model_zoo.vision.alexnet",
                "gluon.model_zoo.vision.mobilenet",
                "gluon.model_zoo.vision.squeezenet",
                "gluon.model_zoo.vision.densenet",
                "gluon.model_zoo.vision.inception", "gluon.model_zoo")


def test_vision_slice_modules_stand_alone():
    """The vision slice's modules (the conv, pooling and norm ops and
    layers, the model store, the zoo) import alone in a fresh
    interpreter, each without loading jax or the reference package; then
    bench.py's training step (`DataParallel`, SGD with momentum) runs on
    a small ResNet on the CPU, and the packaged digits weights load,
    still without them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {VISION_SLICE!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import numpy as onp\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import gluon, np, optimizer\n"
        "from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store\n"
        "from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import ("
        "mobilenet0_25, resnet18_v1)\n"
        "from incubator_mxnet_tpu_torch.parallel.sharded import "
        "DataParallel\n"
        "with mx.cpu():\n"
        "    net = resnet18_v1(classes=10)\n"
        "    net.initialize()\n"
        "    rng = onp.random.RandomState(0)\n"
        "    net(np.array(rng.uniform(-1, 1, (1, 3, 32, 32))"
        ".astype('float32')))\n"
        "    dp = DataParallel(net, gluon.loss.SoftmaxCrossEntropyLoss(),"
        " optimizer.SGD(learning_rate=0.01, momentum=0.9))\n"
        "    x = np.array(rng.uniform(-1, 1, (2, 3, 32, 32))"
        ".astype('float32'))\n"
        "    y = np.array(rng.randint(0, 10, (2,)).astype('int32'))\n"
        "    loss = dp.step(x, y)\n"
        "    assert onp.isfinite(float(loss.asnumpy()))\n"
        "    m = mobilenet0_25(classes=10)\n"
        "    m.load_parameters(model_store.get_model_file("
        "'mobilenet0.25_digits'))\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


REMAINDER_SLICE = ("util", "random", "test_utils", "numpy.linalg",
                   "numpy.random", "numpy_extension._transformer",
                   "numpy_extension._contrib_misc", "ndarray.legacy_ops",
                   "ndarray.legacy_io", "ndarray.contrib")


def test_np_remainder_modules_stand_alone(tmp_path):
    """The np/npx/nd remainder's modules (the mode switches, linalg, the
    distributions, the transformer and contrib ops, the legacy ops, the
    legacy container, nd.contrib) import alone in a fresh interpreter,
    each without loading jax or the reference package; then a
    reference-style ``npx.set_np()`` script runs on the CPU and a legacy
    ``.params`` file round-trips, still without them."""
    params = str(tmp_path / "w.params")
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {REMAINDER_SLICE!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import np, npx, autograd\n"
        "npx.set_np()\n"
        "npx.seed(0)\n"
        "with mx.cpu():\n"
        "    qkv = np.random.normal(size=(5, 2, 24))\n"
        "    qkv.attach_grad()\n"
        "    with autograd.record():\n"
        "        att = npx.interleaved_matmul_selfatt_qk(qkv, heads=2)\n"
        "        att = npx.masked_softmax(att, np.ones((4, 5, 5)))\n"
        "        out = npx.interleaved_matmul_selfatt_valatt(qkv, att,"
        " heads=2)\n"
        "        loss = npx.pick(npx.topk(out, k=2, ret_typ='value'),"
        " npx.one_hot(np.zeros((5, 2)), 2).argmax(-1)).sum()\n"
        "    loss.backward()\n"
        "    assert qkv.grad.shape == (5, 2, 24)\n"
        "    assert np.linalg.solve(np.eye(3) * 2, np.ones(3)).shape == (3,)\n"
        "    assert np.random.gamma(2.0, size=4).shape == (4,)\n"
        f"    mx.nd.save({params!r}, {{'w': qkv}}, format='legacy')\n"
        f"    assert mx.nd.load({params!r})['w'].shape == (5, 2, 24)\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


PROFILER_AND_ANALYSIS = ("profiler", "analysis", "analysis.auditor",
                         "analysis.findings", "telemetry.kernels",
                         "telemetry.roofline", "telemetry.stages",
                         "telemetry.monitor", "telemetry.registry",
                         "_graphs")


def test_profiler_and_analysis_modules_stand_alone():
    """The profiler, the kernel census and roofline, the funnel's stages,
    the monitor and the auditor each import alone in a fresh interpreter
    without loading jax or the reference package; then a profiled,
    staged, monitored and audited program runs on the CPU, still without
    them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {PROFILER_AND_ANALYSIS!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import profiler\n"
        "from incubator_mxnet_tpu_torch.telemetry import (kernels, monitor,"
        " roofline, stages)\n"
        "with mx.cpu():\n"
        "    a = mx.np.ones((4, 4))\n"
        "    profiler.start(); stages.enable()\n"
        "    monitor.install_nan_hook('raise')\n"
        "    b = mx.np.dot(a, a) + 1\n"
        "    profiler.stop(); stages.disable()\n"
        "    assert 'dot' in profiler.dumps()\n"
        "    assert stages.stage_report()['dispatch']['count'] >= 2\n"
        "    assert kernels.census()['rows'] == []\n"
        "    assert roofline.from_profiler()['rows'] == []\n"
        "    rep = mx.analysis.audit(lambda x: x * float(x.sum()), a)\n"
        "    assert rep.by_kind('host-sync')\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


TRAINING_LOOP = ("gluon.data", "gluon.data.dataset", "gluon.data.sampler",
                 "gluon.data.batchify", "gluon.data.dataloader",
                 "gluon.data.vision", "gluon.data.vision.datasets",
                 "gluon.data.vision.transforms", "gluon.metric",
                 "gluon.contrib", "gluon.contrib.data.vision",
                 "gluon.contrib.estimator", "telemetry.monitor", "callback",
                 "model", "preemption", "fault.resilience", "recordio",
                 "_native", "image", "io")


def test_training_loop_modules_stand_alone(tmp_path):
    """The training loop's ecosystem (the data pipeline, the metrics, the
    Estimator and its handlers, the checkpointers, resilience, RecordIO,
    image and io) imports alone in a fresh interpreter, each module
    without loading jax or the reference package; then a tiny net is
    fitted through `Estimator.fit` fed by a two-worker `DataLoader`, with
    a resilient checkpointer, on the CPU, and a record file is packed and
    read back through `io.ImageRecordIter`, still without them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {TRAINING_LOOP!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import numpy as onp\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import gluon, io, preemption,"
        " recordio\n"
        "from incubator_mxnet_tpu_torch.fault.resilience import"
        " ResilienceHandler\n"
        "from incubator_mxnet_tpu_torch.gluon.contrib.estimator import"
        " Estimator\n"
        "r = onp.random.RandomState(0)\n"
        "x = r.normal(size=(16, 4)).astype('float32')\n"
        "y = r.randint(0, 2, 16).astype('int32')\n"
        "with mx.cpu():\n"
        "    net = gluon.nn.Dense(2, in_units=4)\n"
        "    net.initialize()\n"
        "    tr = gluon.Trainer(net.collect_params(), 'sgd')\n"
        "    est = Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),"
        " trainer=tr)\n"
        f"    ck = preemption.TrainingCheckpointer({str(tmp_path / 'c')!r},"
        " net, tr, every_n=2, register_signal=False)\n"
        "    dl = gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),"
        " batch_size=4, num_workers=2)\n"
        "    est.fit(dl, batches=6, event_handlers=[ResilienceHandler(ck)])\n"
        "    assert ck._mgr.latest().endswith('0000006.ckpt')\n"
        f"    rec = recordio.MXIndexedRecordIO({str(tmp_path / 'i.idx')!r},"
        f" {str(tmp_path / 'i.rec')!r}, 'w')\n"
        "    for i in range(4):\n"
        "        rec.write_idx(i, recordio.pack_img(recordio.IRHeader(0,"
        " float(i), i, 0), r.randint(0, 256, (10, 10, 3)).astype('uint8')))\n"
        "    rec.close()\n"
        f"    it = io.ImageRecordIter({str(tmp_path / 'i.rec')!r},"
        " (3, 8, 8), batch_size=2)\n"
        "    assert next(it).data[0].shape == (2, 3, 8, 8)\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_distributed_modules_and_workers_stand_alone(tmp_path):
    """Each rank of a 2-rank gloo world (`torch_worlds/`) imports every
    distributed module of the port (`parallel`, `kvstore`,
    `models.sharded_bert`, `gluon.contrib.moe`) and trains a step of a
    tiny BERT over tp = 2 without loading jax or the reference package."""
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_worlds import world

    ranks = world.spawn(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "torch_worlds", "isolation.py"), 2,
        tmp_path)
    assert [r["forbidden"] for r in ranks] == [[], []]
    assert ranks[0]["loss"] == ranks[1]["loss"]


INT8_AND_RNN = ("ops.quantized", "contrib", "contrib.quantization",
                "gluon.rnn", "gluon.rnn.rnn_layer", "gluon.rnn.rnn_cell",
                "gluon.rnn.conv_rnn_cell")


def test_int8_and_rnn_modules_stand_alone():
    """The int8 quantization (`ops.quantized`, `contrib.quantization`) and
    the RNN family (`gluon.rnn`, `npx.rnn`) import alone in a fresh
    interpreter, each module without loading jax or the reference package;
    then a tiny ResNet is quantized and run, and the store's character LM
    runs, on the CPU, still without them."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        f"for m in {INT8_AND_RNN!r}:\n"
        "    importlib.import_module('incubator_mxnet_tpu_torch.' + m)\n"
        "    assert not bad(), (m, bad())\n"
        "import numpy as onp\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import gluon\n"
        "from incubator_mxnet_tpu_torch.contrib.quantization import"
        " quantize_net\n"
        "from incubator_mxnet_tpu_torch.gluon.model_zoo import vision\n"
        "x = onp.random.RandomState(0).uniform(-1, 1, (2, 3, 32, 32))"
        ".astype('float32')\n"
        "with mx.cpu():\n"
        "    net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],"
        " [8, 8, 16, 32, 64], classes=10)\n"
        "    net.initialize()\n"
        "    xs = mx.np.array(x)\n"
        "    net(xs)\n"
        "    quantize_net(net, calib_data=[xs], calib_mode='naive')\n"
        "    assert net(xs).shape == (2, 10)\n"
        "    lstm = gluon.rnn.LSTM(8, num_layers=2, layout='NTC')\n"
        "    lstm.initialize()\n"
        "    assert lstm(mx.np.array(x[:, 0])).shape == (2, 32, 8)\n"
        "print('LOADED', bad())\n"
        "assert not bad(), bad()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
