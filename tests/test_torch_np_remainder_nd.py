"""``mx.nd``'s legacy long tail (`legacy_ops`), ``nd.contrib``,
``nd.sample_multinomial`` and the reference's binary ``.params``
container (`legacy_io`, ``nd.save(format="legacy")``/``nd.load``,
``Block.load_parameters``) against the JAX package: outputs and
gradients on the same numpy inputs (`test_torch_np_remainder.both`,
rtol 1e-5 / atol 1e-6 unless a case says LOOSE), the loss ops' reference
backward formulas, and the legacy files byte for byte.
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from test_torch_np_remainder import LOOSE, TOL, both

R = onp.random.RandomState(7)
X34 = R.uniform(-1, 1, (3, 4)).astype("float32")
IMG = R.uniform(-1, 1, (2, 8, 4, 6)).astype("float32")
LBL = onp.array([2, 0, 3], "float32")
Y34 = R.uniform(0, 1, (3, 4)).astype("float32")

LEGACY = {
    "slice_axis": (lambda mx, x: mx.nd.slice_axis(x, axis=1, begin=1,
                                                  end=-1), [X34], (0,)),
    "crop": (lambda mx, x: mx.nd.crop(x, begin=(1, 0), end=(3, 2)), [X34],
             (0,)),
    "reverse": (lambda mx, x: mx.nd.reverse(x, axis=1), [X34], (0,)),
    "depth_to_space": (lambda mx, x: mx.nd.depth_to_space(x, 2), [IMG],
                       (0,)),
    "space_to_depth": (lambda mx, x: mx.nd.space_to_depth(x, 2), [IMG],
                       (0,)),
    "im2col": (lambda mx, x: mx.nd.im2col(x, (3, 2), stride=(1, 2),
                                          dilate=(1, 1), pad=(1, 0)),
               [IMG], (0,)),
    "col2im": (lambda mx, c: mx.nd.col2im(c, (4, 6), (3, 2), stride=(1, 2),
                                          pad=(1, 0)),
               [R.uniform(size=(2, 48, 12)).astype("float32")], (0,)),
    "moments": (lambda mx, x: mx.nd.moments(x, axes=(0, 2)), [IMG], (0,)),
    "moments_keepdims": (lambda mx, x: mx.nd.moments(x, keepdims=True),
                         [X34], (0,)),
    "hard_sigmoid": (lambda mx, x: mx.nd.hard_sigmoid(x * 4, 0.3, 0.4),
                     [X34], (0,)),
    "mish": (lambda mx, x: mx.nd.mish(x), [X34], (0,)),
    "log_sigmoid": (lambda mx, x: mx.nd.log_sigmoid(x), [X34], (0,)),
    "rcbrt": (lambda mx, x: mx.nd.rcbrt(x + 2), [X34], (0,)),
    "rsqrt": (lambda mx, x: mx.nd.rsqrt(x + 2), [X34], (0,)),
    "softmax_cross_entropy": (
        lambda mx, x, y: mx.nd.softmax_cross_entropy(x, y), [X34, LBL],
        (0,)),
    "make_loss": (lambda mx, x: mx.nd.make_loss(x * x, grad_scale=0.5),
                  [X34], (0,)),
    "BlockGrad": (lambda mx, x: mx.nd.BlockGrad(x) * x + x, [X34], (0,)),
    "LRN": (lambda mx, x: mx.nd.LRN(x, nsize=3), [IMG], (0,)),
    "UpSampling_nearest": (
        lambda mx, x: mx.nd.UpSampling(x, scale=2), [IMG[:, :2]], (0,)),
    "UpSampling_multi_concat": (
        lambda mx, x, y: mx.nd.UpSampling(x, y, scale=2, num_args=2),
        [IMG[:, :2], IMG[:, 2:3]], (0, 1)),
    "UpSampling_bilinear_weight": (
        lambda mx, x, w: mx.nd.UpSampling(x, w, scale=2,
                                          sample_type="bilinear"),
        [IMG[:, :2], R.uniform(size=(2, 1, 4, 4)).astype("float32")],
        (0, 1)),
    "SoftmaxActivation": (lambda mx, x: mx.nd.SoftmaxActivation(x), [IMG],
                          (0,)),
    "SoftmaxActivation_channel": (
        lambda mx, x: mx.nd.SoftmaxActivation(x, mode="channel"), [IMG],
        (0,)),
    "LinearRegressionOutput": (
        lambda mx, x, y: mx.nd.LinearRegressionOutput(x, y, grad_scale=2.0),
        [X34, Y34], (0,)),
    "MAERegressionOutput": (
        lambda mx, x, y: mx.nd.MAERegressionOutput(x, y), [X34, Y34], (0,)),
    "LogisticRegressionOutput": (
        lambda mx, x, y: mx.nd.LogisticRegressionOutput(x, y), [X34, Y34],
        (0,)),
    "SVMOutput_l2": (lambda mx, x, y: mx.nd.SVMOutput(x, y, margin=0.5),
                     [X34, LBL], (0,)),
    "SVMOutput_l1": (lambda mx, x, y: mx.nd.SVMOutput(
        x, y, regularization_coefficient=0.3, use_linear=True), [X34, LBL],
        (0,)),
    "IdentityAttachKLSparseReg": (
        lambda mx, x: mx.nd.IdentityAttachKLSparseReg(x, penalty=0.01),
        [Y34], (0,)),
    "argmax_channel": (lambda mx, x: mx.nd.argmax_channel(x), [IMG], ()),
    "choose_element_0index": (
        lambda mx, x, i: mx.nd.choose_element_0index(x, i), [X34, LBL],
        (0,)),
    "size_array": (lambda mx, x: mx.nd.size_array(x), [IMG], ()),
    "broadcast_axis": (lambda mx, x: mx.nd.broadcast_axis(x, axis=0,
                                                          size=3),
                       [X34[:1]], (0,)),
    "broadcast_axes": (lambda mx, x: mx.nd.broadcast_axes(
        x, axis=(0, 2), size=(2, 5)), [X34[:1, :, None]], (0,)),
    "cast_storage_dense": (lambda mx, x: mx.nd.cast_storage(x, "default"),
                           [X34], (0,)),
}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_op_matches_the_reference(name):
    fn, inputs, grad = LEGACY[name]
    tol = LOOSE if name.startswith(("LRN", "im2col", "col2im", "UpSampling",
                                    "gamma")) else TOL
    both(fn, inputs, grad, tol)


# the legacy names nd forwards to npx (and nd.contrib's): each resolves to
# the same op as in the reference, whose parity case is in
# test_torch_np_remainder.py
FORWARDED = ("Cast cast ElementWiseSum L2Normalization SequenceMask "
             "SequenceLast SequenceReverse SliceChannel slice_channel "
             "SoftmaxOutput gamma gammaln digamma erfinv topk pick one_hot "
             "slice boolean_mask gather_nd scatter_nd slice_like "
             "broadcast_like sequence_mask").split()
CONTRIB_FORWARDED = ("quadratic index_copy index_array gradientmultiplier "
                     "dynamic_reshape round_ste sign_ste boolean_mask "
                     "interleaved_matmul_selfatt_qk "
                     "interleaved_matmul_selfatt_valatt "
                     "interleaved_matmul_encdec_qk "
                     "interleaved_matmul_encdec_valatt div_sqrt_dim "
                     "sldwin_atten_score sldwin_atten_context "
                     "sldwin_atten_mask_like allclose arange_like "
                     "AdaptiveAvgPooling2D BatchNormWithReLU "
                     "DeformableConvolution "
                     "ModulatedDeformableConvolution").split()


def test_forwarded_names_resolve_to_the_references_ops():
    def op_name(fn):
        return getattr(fn, "__name__", None)

    for ns, names in (("", FORWARDED), ("contrib", CONTRIB_FORWARDED)):
        ref = jmx.nd if not ns else jmx.nd.contrib
        port = tmx.nd if not ns else tmx.nd.contrib
        for n in names:
            assert op_name(getattr(port, n)) == op_name(getattr(ref, n)), n
    assert tmx.nd.ElementWiseSum is tmx.npx.add_n
    assert tmx.nd.gamma is tmx.npx.gamma    # the Γ function, not a draw
    assert tmx.nd.SoftmaxOutput is tmx.npx.softmax
    assert tmx.nd.MakeLoss is tmx.nd.make_loss
    assert jmx.nd.MakeLoss is jmx.nd.make_loss


def test_loss_ops_backward_is_the_references_formula():
    """The regression outputs' gradient is (transform(x) - y)·scale /
    batch whatever comes in, not the gradient of the forward."""
    with tmx.cpu():
        x, y = tmx.np.array(X34), tmx.np.array(Y34)
        x.attach_grad()
        with tmx.autograd.record():
            out = tmx.nd.LogisticRegressionOutput(x, y, grad_scale=3.0)
        out.backward(tmx.np.array(onp.full((3, 4), 7.0, "float32")))
    sig = 1 / (1 + onp.exp(-X34.astype("float64")))
    onp.testing.assert_allclose(x.grad.asnumpy(), (sig - Y34) * 3.0 / 3,
                                rtol=1e-5, atol=1e-6)


def test_contrib_forwards_and_raises_for_the_rest():
    assert tmx.nd.contrib.index_copy is tmx.npx.index_copy
    assert tmx.nd.contrib.BatchNormWithReLU is tmx.npx.batch_norm_with_relu
    assert "box_nms" not in dir(tmx.nd.contrib)
    for name in ("box_nms", "ctc_loss", "fft", "MultiBoxPrior",
                 "dgl_subgraph"):
        with pytest.raises(MXNetError, match="item 11b") as e:
            getattr(tmx.nd.contrib, name)
        assert not isinstance(e.value, AttributeError)
    with pytest.raises(AttributeError):
        tmx.nd.contrib.no_such_op


def test_cast_storage_to_sparse_names_its_item():
    with tmx.cpu(), pytest.raises(MXNetError, match="item 11b"):
        tmx.nd.cast_storage(tmx.np.array(X34), "row_sparse")


def _ref_abstract(fn):
    """The reference's random call traced abstractly (``jax.eval_shape``:
    its shapes and dtypes without compiling its samplers), the key
    source's state restored after."""
    import jax

    def arrays():
        out = fn()
        return [o._data for o in (out if isinstance(out, tuple) else (out,))]

    state = jmx.random._STATE
    saved = state.key
    try:
        return tuple(jax.eval_shape(arrays))
    finally:
        state.key = saved


def test_sample_multinomial_shapes_dtypes_and_probabilities():
    probs = onp.array([[0.1, 0.9, 0.0], [0.5, 0.25, 0.25]], "float32")
    for kw in (dict(shape=4), dict(shape=(2, 3), get_prob=True)):
        want = _ref_abstract(lambda: jmx.nd.sample_multinomial(
            jmx.np.array(probs), **kw))
        with tmx.cpu():
            got = tmx.nd.sample_multinomial(tmx.np.array(probs), **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        if kw.get("get_prob"):
            d, lp = got[0].asnumpy(), got[1].asnumpy()
            rows = onp.broadcast_to(probs[:, None, None], (2, 2, 3, 3))
            picked = onp.take_along_axis(rows, d[..., None], -1)[..., 0]
            onp.testing.assert_allclose(lp, onp.log(picked), rtol=1e-6)
    with tmx.cpu():
        tmx.random.seed(2)
        d = tmx.nd.sample_multinomial(tmx.np.array(probs[0]),
                                      shape=20000).asnumpy()
    assert (d != 2).all() and abs((d == 1).mean() - 0.9) < 0.01


LEGACY_RANDOM = [  # (name, positional parameters, keywords)
    ("normal", (), dict(loc=1.0, scale=2.0, shape=(3, 4))),
    ("uniform", (), dict(low=-1.0, high=1.0, shape=5)),
    ("poisson", (), dict(lam=3.0, shape=(2, 2))),
    ("exponential", (), dict(scale=2.0, shape=(3,))),
    # the gamma's shape parameter goes by position: `shape=` is the size
    ("random_gamma", (2.0,), dict(shape=(2, 3))),
    ("negative_binomial", (), dict(n=3, p=0.4, shape=(4,))),
    ("generalized_negative_binomial", (), dict(mu=2.0, alpha=0.5,
                                               shape=(4,))),
    ("random_normal", (), dict(shape=(2,), dtype="float16")),
]


@pytest.mark.parametrize("name,args,kw", LEGACY_RANDOM,
                         ids=[c[0] for c in LEGACY_RANDOM])
def test_legacy_random_names_shape_and_dtype(name, args, kw):
    (want,) = _ref_abstract(lambda: getattr(jmx.nd, name)(*args, **kw))
    with tmx.cpu():
        got = getattr(tmx.nd, name)(*args, **kw)
        like = getattr(tmx.nd, name.replace("random_", "") + "_like"
                       if name != "random_gamma" else "gamma_like")(
            tmx.np.array(X34), *args, **{k: v for k, v in kw.items()
                                         if k not in ("shape", "dtype")})
    assert got.shape == want.shape and got.dtype == want.dtype
    assert like.shape == X34.shape


def test_nd_shuffle_permutes_rows_with_the_key_source():
    with tmx.cpu():
        x = tmx.np.array(onp.arange(20, dtype="float32").reshape(10, 2))
        tmx.random.seed(9)
        a = tmx.nd.shuffle(x).asnumpy()
        tmx.random.seed(9)
        b = tmx.nd.shuffle(x).asnumpy()
    onp.testing.assert_array_equal(a, b)
    assert sorted(a[:, 0].tolist()) == list(range(0, 20, 2))
    assert (a[:, 1] == a[:, 0] + 1).all()


# ---------------------------------------------------------------------------
# the reference's binary container
# ---------------------------------------------------------------------------

ARRAYS = {"w": R.uniform(size=(3, 4)).astype("float32"),
          "b": onp.arange(5, dtype="int32"),
          "h": R.uniform(size=(2, 2)).astype("float16"),
          "s": onp.array(2.5, "float32")}


@pytest.mark.parametrize("named", [True, False])
def test_legacy_files_are_byte_for_byte_the_references(tmp_path, named):
    data_j = {k: jmx.np.array(v, dtype=v.dtype) for k, v in ARRAYS.items()}
    with tmx.cpu():
        data_t = {k: tmx.np.array(v, dtype=v.dtype) for k, v in
                  ARRAYS.items()}
    if not named:
        data_j, data_t = list(data_j.values()), list(data_t.values())
    pj, pt = str(tmp_path / "ref.params"), str(tmp_path / "port.params")
    jmx.nd.save(pj, data_j, format="legacy")
    tmx.nd.save(pt, data_t, format="legacy")
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    # each package loads the other's file
    with tmx.cpu():
        got = tmx.nd.load(pj)
    want = jmx.nd.load(pt)
    if named:
        assert list(got) == list(want) == list(ARRAYS)
        got, want = list(got.values()), list(want.values())
    for g, w, a in zip(got, want, ARRAYS.values()):
        assert g.dtype == w.dtype == a.dtype and g.shape == a.shape
        onp.testing.assert_array_equal(g.asnumpy(), a)
        onp.testing.assert_array_equal(w.asnumpy(), a)


def test_legacy_bfloat16_round_trips_and_sparse_raises(tmp_path):
    import struct

    import torch

    path = str(tmp_path / "bf16.params")
    with tmx.cpu():
        a = tmx.np.array(X34, dtype="bfloat16")
        tmx.nd.save(path, {"a": a}, format="legacy")
        back = tmx.nd.load(path)["a"]
    assert back._data.dtype == torch.bfloat16
    assert torch.equal(back._data, a._data)
    # a row_sparse blob (the reference's V2 layout) names its item
    sparse = str(tmp_path / "sparse.params")
    with open(sparse, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, 1)
                + struct.pack("<Ii", 0xF993FAC9, 1) + b"\x00" * 64)
    with pytest.raises(MXNetError, match="item 11b"):
        tmx.nd.load(sparse)


def test_load_parameters_reads_a_legacy_params_file(tmp_path):
    """A reference-written binary ``.params`` (with MXNet's ``arg:``
    prefixes) loads into the port's block, and the port's own legacy file
    into the reference's."""
    net_j = jmx.gluon.nn.Dense(3, in_units=4)
    jmx.random.seed(1)
    net_j.initialize()
    params = {f"arg:{k}": v.data() for k, v in
              net_j.collect_params().items()}
    path = str(tmp_path / "dense.params")
    jmx.nd.save(path, params, format="legacy")
    with tmx.cpu():
        net_t = tmx.gluon.nn.Dense(3, in_units=4)
        net_t.initialize()
        net_t.load_parameters(path)
        x = tmx.np.array(X34)
        got = net_t(x).asnumpy()
        out = str(tmp_path / "port.params")
        tmx.nd.save(out, {k: v.data() for k, v in
                          net_t.collect_params().items()}, format="legacy")
    onp.testing.assert_allclose(got, net_j(jmx.np.array(X34)).asnumpy(),
                                **TOL)
    net_j2 = jmx.gluon.nn.Dense(3, in_units=4)
    net_j2.initialize()
    net_j2.load_parameters(out)
    for (_, p), (_, q) in zip(net_j.collect_params().items(),
                              net_j2.collect_params().items()):
        onp.testing.assert_array_equal(p.data().asnumpy(),
                                       q.data().asnumpy())
    nameless = str(tmp_path / "nameless.params")
    jmx.nd.save(nameless, list(params.values()), format="legacy")
    with tmx.cpu(), pytest.raises(MXNetError, match="no parameter names"):
        net_t.load_parameters(nameless)
