"""Calls that are valid in the JAX package and failed in the port
(`ROADMAP.md` §3), each made on both packages: the ported names the
port's namespaces did not export, ``np.clip`` with no bounds and
``np.can_cast`` on arrays (``mx.np`` and ``mx.nd``), and the kernel
modules' signatures in the reference's order (``gelu_dropout(u, p,
seeds, interpret)``, ``flash_attention(..., block_q, block_k,
interpret)``, ``layer_norm(x, gamma, beta, eps, block_r, interpret)``).

The ``dir()`` test holds every public name of each ported namespace of
the reference (its submodules too, imported or not) to the port's, less
a declared list of the names not yet ported (each with the
`ROADMAP.md` §1 item that ports it) and of the reference's incidental
module imports; it fails when the port grows a declared name, so the
list stays true.
"""
import importlib

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

# the reference's module-level imports and re-exported helpers, not API
INCIDENTAL = {"os", "re", "functools", "onp", "annotations", "Callable",
              "Sequence", "np_dtype", "apply_op_flat", "register_aux_update",
              "next_key"}

ITEM_11B = "ROADMAP.md §1 item 11b (the rest of the breadth)"

NPX_ITEM_11B = (
    "bilinear_resize2d bilinear_sampler bipartite_matching "
    "box_decode box_encode box_iou box_nms correlation count_sketch "
    "ctc_loss deformable_psroi_pooling dgl_adjacency "
    "dgl_csr_neighbor_non_uniform_sample dgl_csr_neighbor_uniform_sample "
    "dgl_graph_compact dgl_subgraph edge_id fft getnnz grid_generator "
    "hawkesll ifft mrcnn_mask_target multi_proposal multibox_detection "
    "multibox_prior multibox_target proposal psroi_pooling "
    "roi_align roi_pooling rroi_align spatial_transformer "
    "sync_batch_norm").split()
ND_ITEM_11B = (
    "BilinearResize2D BilinearSampler CTCLoss Correlation GridGenerator "
    "ROIAlign ROIPooling SpatialTransformer box_iou box_nms "
    "ctc_loss sparse").split()
# nd.contrib's names that are not ported: the reference forwards its
# whole contrib corpus
ND_CONTRIB_ITEM_11B = (
    "BilinearResize2D DeformablePSROIPooling MultiBoxDetection MultiBoxPrior "
    "MultiBoxTarget MultiProposal PSROIPooling Proposal ROIAlign RROIAlign "
    "SyncBatchNorm bipartite_matching box_decode box_encode box_iou box_nms "
    "count_sketch ctc_loss deformable_psroi_pooling dgl_adjacency "
    "dgl_csr_neighbor_non_uniform_sample dgl_csr_neighbor_uniform_sample "
    "dgl_graph_compact dgl_subgraph edge_id fft getnnz hawkesll ifft "
    "mrcnn_mask_target multi_proposal proposal psroi_pooling "
    "rroi_align").split()

NOT_PORTED = {
    "": dict.fromkeys(
        "partition remat".split(), ITEM_11B) | dict.fromkeys(
        "AttrScope attribute context engine error executor libinfo library "
        "log name onnx operator registry rtc runtime sym symbol utils "
        "visualization viz".split(), ITEM_11B),
    "models": {},
    "serve": {}, "serve.sharded": {}, "serve.router": {},
    "ops": {},
    "gluon": dict.fromkeys("probability".split(), ITEM_11B),
    "gluon.rnn": {},
    "gluon.nn": {},
    "gluon.model_zoo": {},
    "gluon.model_zoo.vision": {},
    "gluon.model_zoo.model_store": {},
    # distributed training (`functools.partial` and `threading` are the
    # reference modules' imports, not names of their API)
    "parallel": {}, "parallel.mesh": {}, "parallel.collectives": {},
    "parallel.dist": {"threading": "an import, not an API name"},
    "parallel.ring_attention": {"partial": "an import, not an API name"},
    "parallel.pipeline": {}, "parallel.moe": {}, "kvstore": {},
    "models.sharded_bert": {"partial": "an import, not an API name"},
    "amp": {}, "optimizer": {}, "lr_scheduler": {},
    "fault": {},
    "device": {}, "base": {},
    "autograd": {"TapeNode": "the port's tape is torch's autograd graph",
                 "vjp_cache_info": "eager torch has no vjp program cache"},
    "random": {},
    "initializer": {},
    "numpy_extension": dict.fromkeys(NPX_ITEM_11B + ["image"], ITEM_11B),
    "ndarray": dict.fromkeys(ND_ITEM_11B, ITEM_11B),
    "ndarray.contrib": dict.fromkeys(ND_CONTRIB_ITEM_11B, ITEM_11B),
    "numpy": {},
    "numpy.linalg": {},
    "numpy.random": {},
    "telemetry": {}, "telemetry.fleet": {},
    "telemetry.monitor": {},
    "telemetry.kernels": {}, "telemetry.roofline": {},
    "telemetry.stages": {}, "telemetry.registry": {},
    "analysis": dict.fromkeys(
        "racecheck racecheck_fixtures racecheck_paths racecheck_report "
        "racecheck_source runtime_report".split(), ITEM_11B),
    # the reference reads XPlane's gzipped trace files; torch.profiler
    # exports plain JSON
    "profiler": dict.fromkeys("glob gzip".split(),
                              "torch.profiler's trace is plain JSON"),
    "util": {},
    "test_utils": {},
    "contrib": dict.fromkeys("tensorboard text".split(), ITEM_11B),
    "contrib.quantization": {},
    # the training loop's ecosystem
    "gluon.data": {}, "gluon.data.dataset": {}, "gluon.data.sampler": {},
    "gluon.data.batchify": {}, "gluon.data.dataloader": {},
    "gluon.data.vision": {}, "gluon.data.vision.datasets": {},
    # the reference's funnel import: the port's transforms compute on the
    # host in numpy
    "gluon.data.vision.transforms": {
        "apply_op": "host numpy transforms, no funnel op"},
    "gluon.metric": {},
    "gluon.contrib": {}, "gluon.contrib.moe": {},
    "gluon.contrib.data": {}, "gluon.contrib.data.vision": {},
    "gluon.contrib.estimator": {}, "gluon.contrib.estimator.estimator": {},
    "gluon.contrib.estimator.event_handler": {},
    "io": {}, "io.io": {}, "image": {}, "recordio": {}, "callback": {},
    "model": {"sym": ITEM_11B}, "preemption": {}, "fault.resilience": {},
}


def _public(mod):
    """The public names of ``mod`` and, for a package, of all its
    submodules, imported or not (a submodule shows in ``dir()`` only once
    something imported it)."""
    import pkgutil

    names = set(dir(mod))
    if hasattr(mod, "__path__"):
        names |= {m.name for m in pkgutil.iter_modules(mod.__path__)}
    return {n for n in names if not n.startswith("_")} - INCIDENTAL


@pytest.mark.parametrize("ns", sorted(NOT_PORTED))
def test_namespace_exports_the_references_names(ns):
    suffix = "." + ns if ns else ""
    ref = importlib.import_module("incubator_mxnet_tpu" + suffix)
    port = importlib.import_module("incubator_mxnet_tpu_torch" + suffix)
    missing = _public(ref) - _public(port)
    declared = set(NOT_PORTED[ns])
    assert missing == declared, (sorted(missing - declared),
                                 sorted(declared - missing))


def test_exported_device_helpers_answer_as_the_references():
    for mx in (jmx, tmx):
        assert mx.num_tpus() == 0 and mx.gpu_memory_info(0) == (0, 0)
        assert isinstance(mx.memory_stats(), dict)
        assert mx.tpu(0).device_id == 0
    assert tmx.models.BERTClassifier is tmx.models.bert.BERTClassifier
    assert tmx.models.BERTEncoder is tmx.models.bert.BERTEncoder
    assert tmx.models.TransformerEncoderCell is \
        tmx.models.bert.TransformerEncoderCell
    assert tmx.serve.Tenant is tmx.serve.tenancy.Tenant
    assert tmx.serve.MigrationAborted is tmx.serve.disagg.MigrationAborted
    assert callable(tmx.ops.flash_attention) and callable(tmx.ops.mha_flash)


A = onp.random.RandomState(0).normal(size=(3, 4)).astype("float32")


@pytest.mark.parametrize("ns", ["np", "nd"])
def test_clip_with_no_bounds_returns_the_values(ns):
    want = getattr(jmx, ns).clip(jmx.np.array(A)).asnumpy()
    with tmx.cpu():
        a = tmx.np.array(A)
        got = getattr(tmx, ns).clip(a)
    assert got is not a
    onp.testing.assert_array_equal(got.asnumpy(), want)
    onp.testing.assert_array_equal(want, A)


@pytest.mark.parametrize("ns", ["np", "nd"])
def test_can_cast_takes_arrays(ns):
    cases = [lambda mx: (mx.np.array(A), mx.np.array(A)),
             lambda mx: (mx.np.array(A), "float16"),
             lambda mx: (mx.np.array(A), mx.np.array(A.astype("int32"))),
             lambda mx: ("int32", "float64")]
    for make in cases:
        want = getattr(jmx, ns).can_cast(*make(jmx))
        with tmx.cpu():
            got = getattr(tmx, ns).can_cast(*make(tmx))
        assert got.shape == want.shape == ()
        assert got.dtype == onp.bool_ or str(got.dtype) == "bool"
        assert bool(got.asnumpy()) == bool(want.asnumpy())


def test_gelu_dropout_takes_the_references_order():
    jfb = importlib.import_module("incubator_mxnet_tpu.ops.fused_block")
    from incubator_mxnet_tpu_torch.ops import fused_block as tfb

    u = onp.random.RandomState(1).normal(size=(4, 128)).astype("float32")
    want = onp.asarray(jfb.gelu_dropout(u, 0.0, onp.array([3, 4], "int32"),
                                        True))
    got = tfb.gelu_dropout(torch.from_numpy(u), 0.0, (3, 4), True)
    onp.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    # p > 0: the seeds, not p, key the mask (same key, same mask)
    a = tfb.gelu_dropout(torch.from_numpy(u), 0.5, (3, 4))
    assert torch.equal(a, tfb.gelu_dropout(torch.from_numpy(u), 0.5, (3, 4)))
    assert (a == 0).any()


def test_flash_attention_and_layer_norm_take_the_references_knobs():
    jfa = importlib.import_module("incubator_mxnet_tpu.ops.flash_attention")
    jln = importlib.import_module("incubator_mxnet_tpu.ops.layer_norm")
    r = onp.random.RandomState(2)
    q, k, v = (r.normal(size=(1, 2, 16, 8)).astype("float32")
               for _ in range(3))
    want = onp.asarray(jmx.ops.flash_attention(q, k, v, causal=True,
                                               block_q=8, block_k=8,
                                               interpret=True))
    got = tmx.ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, block_q=8, block_k=8,
                                  interpret=True)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    x = r.normal(size=(16, 128)).astype("float32")
    g, b = r.normal(size=128).astype("float32"), r.normal(size=128).astype(
        "float32")
    want = onp.asarray(jln.layer_norm(x, g, b, 1e-5, 8, True))
    from incubator_mxnet_tpu_torch.ops import layer_norm as tln

    got = tln.layer_norm(*map(torch.from_numpy, (x, g, b)), 1e-5, 8, True)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
