"""Every loss of the port against the JAX package: the per-sample loss and
its gradient with respect to the predictions (and, where they are
differentiable, the other inputs), with ``weight``, ``sample_weight``,
``batch_axis``, the sparse/dense and logits/probabilities variants and
CTC's lengths, on NDArrays under ``autograd.record()`` in both packages;
and the same loss on torch tensors (the port's module path) equal to its
NDArray call. Tolerance 1e-5 (float32)."""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TOL = 1e-5


def _arrays(seed):
    r = onp.random.RandomState(seed)
    f = lambda *s: r.normal(size=s).astype("float32")  # noqa: E731
    return {
        "p": f(4, 6), "l": f(4, 6), "p3": f(4, 3, 5), "l3": f(4, 3, 5),
        "prob": r.uniform(0.05, 0.95, (4, 6)).astype("float32"),
        "bin": r.randint(0, 2, (4, 6)).astype("float32"),
        "sign": (2 * r.randint(0, 2, (4, 6)) - 1).astype("float32"),
        "cls": r.randint(0, 6, (4,)).astype("int32"),
        "cls3": r.randint(0, 5, (4, 3)).astype("int32"),
        "cls_ax": r.randint(0, 3, (4, 5)).astype("int32"),
        "onehot": onp.eye(6, dtype="float32")[r.randint(0, 6, (4,))],
        "sw": r.uniform(0.5, 1.5, (4, 1)).astype("float32"),
        "sw3": r.uniform(0.5, 1.5, (4, 3)).astype("float32"),
        "pw": r.uniform(0.5, 2.0, (6,)).astype("float32"),
        "dist": onp.abs(f(4, 6)) / 3 + 0.01,
        "counts": r.poisson(2.0, (4, 6)).astype("float32"),
        "neg": f(4, 6), "cos_l": onp.array([1, -1, 1, -1], "float32"),
        "ctc_p": f(3, 9, 5), "ctc_l": r.randint(1, 5, (3, 4)).astype("int32"),
        "ctc_pl": onp.array([9, 7, 8], "int32"),
        "ctc_ll": onp.array([4, 2, 3], "int32"),
    }


# (loss class, constructor kwargs, argument names, the differentiable
# positions among them, extra call kwargs by name)
CASES = {
    "l2": ("L2Loss", {}, ["p", "l"], (0,), {}),
    "l2_weighted": ("L2Loss", dict(weight=0.7), ["p", "l", "sw"], (0,), {}),
    "l1": ("L1Loss", dict(weight=1.3), ["p", "l"], (0,), {}),
    "l1_batch_axis": ("L1Loss", dict(batch_axis=1), ["p3", "l3"], (0,), {}),
    "sbce": ("SigmoidBinaryCrossEntropyLoss", {}, ["p", "bin"], (0,), {}),
    "sbce_sw": ("SigmoidBinaryCrossEntropyLoss", dict(weight=0.5),
                ["p", "bin", "sw"], (0,), {}),
    "sbce_pos_weight": ("SigmoidBinaryCrossEntropyLoss", {}, ["p", "bin"],
                        (0,), {"pos_weight": "pw"}),
    "sbce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                          dict(from_sigmoid=True), ["prob", "bin"], (0,), {}),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {}, ["p", "cls"], (0,), {}),
    "softmax_ce_3d_sw": ("SoftmaxCrossEntropyLoss", dict(weight=2.0),
                         ["p3", "cls3", "sw3"], (0,), {}),
    "softmax_ce_dense": ("SoftmaxCrossEntropyLoss", dict(sparse_label=False),
                         ["p", "onehot"], (0,), {}),
    "softmax_ce_logits": ("SoftmaxCrossEntropyLoss",
                          dict(from_logits=True), ["p", "cls"], (0,), {}),
    "softmax_ce_axis": ("SoftmaxCrossEntropyLoss", dict(axis=1),
                        ["p3", "cls_ax"], (0,), {}),
    "kldiv": ("KLDivLoss", {}, ["p", "dist"], (0,), {}),
    "kldiv_probs": ("KLDivLoss", dict(from_logits=False), ["p", "dist"],
                    (0,), {}),
    "huber": ("HuberLoss", dict(rho=0.6), ["p", "l"], (0,), {}),
    "hinge": ("HingeLoss", dict(margin=0.5), ["p", "sign"], (0,), {}),
    "sq_hinge": ("SquaredHingeLoss", {}, ["p", "sign", "sw"], (0,), {}),
    "logistic": ("LogisticLoss", {}, ["p", "sign"], (0,), {}),
    "logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                        ["p", "bin"], (0,), {}),
    "triplet": ("TripletLoss", dict(margin=2.0), ["p", "l", "neg"],
                (0, 1, 2), {}),
    "poisson": ("PoissonNLLLoss", {}, ["p", "counts"], (0,), {}),
    "poisson_full": ("PoissonNLLLoss", dict(from_logits=False,
                                            compute_full=True),
                     ["prob", "counts"], (0,), {}),
    "cosine": ("CosineEmbeddingLoss", dict(margin=0.2), ["p", "l", "cos_l"],
               (0, 1), {}),
    "ctc": ("CTCLoss", {}, ["ctc_p", "ctc_l"], (0,), {}),
    "ctc_lengths": ("CTCLoss", {}, ["ctc_p", "ctc_l", "ctc_pl", "ctc_ll"],
                    (0,), {}),
}


def _run(mx, case, a):
    cls, kw, names, diff, extra = CASES[case]
    loss_fn = getattr(mx.gluon.loss, cls)(**kw)
    if isinstance(loss_fn, mx.gluon.Block):
        loss_fn.initialize()
    args = [mx.np.array(a[n]) for n in names]
    for i in diff:
        args[i].attach_grad()
    kws = {k: mx.np.array(a[v]) for k, v in extra.items()}
    with mx.autograd.record():
        loss = loss_fn(*args, **kws)
    loss.backward()
    return [loss.asnumpy()] + [args[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradient_match_the_reference(case):
    a = _arrays(sorted(CASES).index(case))
    want = _run(jmx, case, a)
    with tmx.cpu():
        got = _run(tmx, case, a)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        onp.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["l2_weighted", "sbce_pos_weight",
                                  "softmax_ce_3d_sw", "kldiv_probs",
                                  "triplet", "cosine", "ctc_lengths"])
def test_tensor_call_equals_the_ndarray_call(case):
    cls, kw, names, diff, extra = CASES[case]
    a = _arrays(3)
    with tmx.cpu():
        nd = _run(tmx, case, a)
    loss_fn = getattr(tmx.gluon.loss, cls)(**kw)
    args = [torch.from_numpy(a[n]) for n in names]
    for i in diff:
        args[i].requires_grad_(True)
    loss = loss_fn(*args, **{k: torch.from_numpy(a[v])
                             for k, v in extra.items()})
    assert isinstance(loss, torch.Tensor)
    loss.backward(torch.ones_like(loss))
    got = [loss.detach().numpy()] + [args[i].grad.numpy() for i in diff]
    for g, w in zip(got, nd):
        onp.testing.assert_array_equal(g, w)
