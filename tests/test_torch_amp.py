"""The port's AMP (`incubator_mxnet_tpu_torch.amp`, bfloat16 target)
against the JAX package's under `amp.init("bfloat16")`: a `bert_small`
(64 units, 2 layers, 4 heads, FFN 128; vocab 97, max_length 32) with the
JAX model's weights carried across by `load_jax_params`, the same seeded
tokens, labels and valid lengths, on CPU tensors (the kernels' plain
versions), dropout 0.

- The dtype map: at every site where the reference's AMP casts or where
  its kernels meet mixed dtypes (embedding, each Dense, the LayerNorms,
  flash attention, both residual sites of each cell, the activations, the
  loss), the port's input and output dtypes equal the reference's, call
  by call. This fails if AMP is silently off, which a tolerance would
  not show.
- Numbers: scores, loss, every parameter gradient (float32) and one Adam
  step. Both sides run their products and activations in bf16 with
  roundings in other places (the port adds the bias inside the product
  and evaluates gelu/tanh in f32 before one rounding; XLA rounds the
  product, then the sum), and at these weights each side lies about 1.3%
  (scores) and up to 5% (gradients) normwise from its own float32 run;
  the reference's own result moves by a few tenths of a percent between
  its traced and untraced calls. So the tolerances are normwise relative,
  at the size of that bf16 error: scores 2^-5, loss 2^-8 (measured on the
  CPU: 0.012-0.016, 0.0004-0.0005); each gradient within twice the
  reference's own distance from the float32 gradient (the port's f32
  step, held to the reference's within 1e-4 by `test_torch_bert.py`), and
  at least 2^-8 (measured: at most 1.02 times that distance, which is
  0.005-0.054). Adam's first step is lr * g / (|g| + eps'),
  eps' = 1e-8 / sqrt(1 - beta2), g the gradient over the batch size:
  where both are at least 1e-4 and agree in sign the two steps differ by at most lr * eps' / 1e-4
  (plus 1e-6 for the parameters' own rounding), everywhere by at most the
  step's bound 2 * lr, and the signs agree on at least 97% of the
  elements.
- Host logic: `scale_loss` / `unscale` / `Trainer._scale` (a scaled step
  equals an unscaled one bit for bit: the scale is a power of two),
  `LossScaler.update_scale` and `has_overflow` as the reference's.
- `convert_model` and `convert_hybrid_block` on a forward against the
  JAX ones (normwise 2^-5, 2^-4 for the all-bf16 `convert_model`, whose
  residual stream is bf16 too).
- A clean exit: after `amp.deinit()` the float32 path is bitwise what it
  was without AMP. `init` takes "bfloat16" (the default) and "float16"
  (`tests/test_torch_amp16.py`).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import autograd, gluon, np
from incubator_mxnet_tpu import numpy_extension as jnpx
from incubator_mxnet_tpu.models.bert import bert_small as jax_bert_small
from incubator_mxnet_tpu_torch import amp
from incubator_mxnet_tpu_torch import numpy_extension as tnpx
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import bert_small
from incubator_mxnet_tpu_torch.optimizer import Adam

VOCAB, T, LR = 97, 24, 1e-2
SCORE_TOL, LOSS_TOL = 2.0 ** -5, 2.0 ** -8
# each AMP gradient: within GRAD_TIMES the reference's AMP gradient's
# normwise distance from the float32 one, and at least GRAD_FLOOR
GRAD_TIMES, GRAD_FLOOR = 2.0, 2.0 ** -8
CONVERT_TOL, CONVERT_ALL_TOL = 2.0 ** -5, 2.0 ** -4
SIGN_AGREE = 0.97
# Adam's first step: |g| >= ADAM_G puts the two steps within
# lr * eps' / ADAM_G of each other, eps' = epsilon / sqrt(1 - beta2)
ADAM_G = 1e-4
ADAM_TOL = LR * 1e-8 / (1 - 0.999) ** 0.5 / ADAM_G + 1e-6
# the reference's ops whose dtypes are recorded, and the operands of each
SITES = {"embedding": (1,), "fully_connected": (0, 1, 2),
         "layer_norm": (0, 1, 2), "flash_attention": (0, 1, 2),
         "residual_dropout_ln": (0, 1, 2, 3), "activation": (0,)}


def _data():
    r = onp.random.RandomState(1)
    tok = r.randint(0, VOCAB, (3, T)).astype("int32")
    lab = r.randint(0, VOCAB, (3, T)).astype("int32")
    return tok, lab, onp.asarray([T, 11, 5], "int32")


def _dt(a):
    """A tensor's dtype name, "float32" or "bfloat16", on either side."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return onp.dtype(a.dtype).name


def _rel(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    return onp.linalg.norm(got - want) / onp.linalg.norm(want)


def _jax_model(params):
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    for n, p in jm.collect_params().items():
        p.set_data(np.array(params[n]))
    return jm


def _recording(module, names, log, pick_of):
    """Wrap ``module``'s functions ``names`` to append (operand dtypes,
    output dtype) to ``log[name]`` for each call made from outside them
    (the reference's composed residual_dropout_ln calls layer_norm)."""
    depth = [0]

    def wrap(name, fn):
        def rec(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                log.setdefault(name, []).append(
                    (tuple(_dt(args[i]) if i < len(args) else None
                           for i in pick_of[name]), _dt(out)))
            return out
        return rec
    patch = pytest.MonkeyPatch()
    for name in names:
        patch.setattr(module, name, wrap(name, getattr(module, name)))
    return patch


@pytest.fixture(scope="module")
def ref():
    """Scaled random weights (the heads see token-dependent inputs) and
    the JAX model's AMP step: the dtypes at each site, scores, loss,
    gradients, the Adam-stepped parameters; and its float32 scores."""
    mx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(0)
    for _name, p in jm.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.2, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    tok, lab, vl = _data()
    dtypes = {}
    patch = _recording(jnpx, SITES, dtypes, SITES)
    jamp.init("bfloat16")
    try:
        trainer = gluon.Trainer(jm.collect_params(), "adam",
                                {"learning_rate": LR})
        with autograd.record():
            mlm, nsp = jm(np.array(tok), None, np.array(vl))
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(mlm, np.array(lab))
        dtypes["loss"] = [((_dt(mlm),), _dt(loss))]
        loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in
                 jm.collect_params().items() if p.grad() is not None}
        trainer.step(tok.shape[0])
    finally:
        jamp.deinit()
        patch.undo()
    return dict(params=params, dtypes=dtypes, grads=grads,
                mlm=onp.asarray(mlm.asnumpy(), onp.float32),
                nsp=onp.asarray(nsp.asnumpy(), onp.float32),
                loss=loss.asnumpy(),
                stepped={n: p.data().asnumpy()
                         for n, p in jm.collect_params().items()})


def _port(params):
    tm = bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0,
                    device="cpu", seed=0)
    tm.load_jax_params(params)
    return tm.train()


def _amp_step(tm, dtypes=None):
    """The port's forward and backward under AMP (the summed loss, as the
    reference's ``loss.backward()``); records the sites' dtypes into
    ``dtypes`` when given."""
    tok, lab, vl = _data()
    patch = hook = None
    if dtypes is not None:
        patch = _recording(tnpx, ("layer_norm", "flash_attention",
                                  "residual_dropout_ln", "activation"),
                           dtypes, SITES)

        def on_forward(mod, args, out):
            if isinstance(mod, tnn.Embedding):
                entry = ((_dt(mod.weight),), _dt(out))
                dtypes.setdefault("embedding", []).append(entry)
            elif isinstance(mod, tnn.Dense):
                entry = ((_dt(args[0]), _dt(mod.weight), _dt(mod.bias)),
                         _dt(out))
                dtypes.setdefault("fully_connected", []).append(entry)
        hook = torch.nn.modules.module.register_module_forward_hook(
            on_forward)
    amp.init("bfloat16")
    try:
        mlm, nsp = tm(torch.from_numpy(tok).long(),
                      valid_length=torch.from_numpy(vl))
        loss = SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab))
        loss.sum().backward()
    finally:
        amp.deinit()
        if patch is not None:
            patch.undo()
            hook.remove()
    if dtypes is not None:
        dtypes["loss"] = [((_dt(mlm),), _dt(loss))]
    return mlm, nsp, loss


def test_dtype_map_matches_the_reference_site_by_site(ref):
    got = {}
    _amp_step(_port(ref["params"]), got)
    want = ref["dtypes"]
    assert sorted(got) == sorted(want)
    for site in want:
        assert got[site] == want[site], site
    f32, bf16 = "float32", "bfloat16"
    # the layouts the kernels meet: the encoder LayerNorm all f32 (the
    # embedding's bf16 promoted by the f32 position embedding), the MLM
    # LayerNorm bf16 x with f32 gamma/beta; every residual site f32 x with
    # a bf16 product h; the products and attention bf16
    assert got["layer_norm"] == [((f32, f32, f32), f32),
                                 ((bf16, f32, f32), bf16)]
    assert set(got["residual_dropout_ln"]) == {((f32, bf16, f32, f32), f32)}
    assert len(got["residual_dropout_ln"]) == 4
    assert set(got["flash_attention"]) == {((bf16,) * 3, bf16)}
    assert {out for _, out in got["fully_connected"]} == {bf16}
    assert got["embedding"] == [((f32,), bf16)]
    assert got["loss"] == [((bf16,), f32)]


def test_scores_and_loss_match_jax_amp(ref):
    mlm, nsp, loss = _amp_step(_port(ref["params"]))
    assert mlm.dtype == nsp.dtype == torch.bfloat16
    assert loss.dtype == torch.float32 and mlm.shape == (3, T, VOCAB)
    assert _rel(mlm.detach().float().numpy(), ref["mlm"]) <= SCORE_TOL
    assert _rel(nsp.detach().float().numpy(), ref["nsp"]) <= SCORE_TOL
    assert _rel(loss.detach().numpy(), ref["loss"]) <= LOSS_TOL


def _f32_grads(params):
    tm = _port(params)
    tok, lab, vl = _data()
    mlm, _ = tm(torch.from_numpy(tok).long(),
                valid_length=torch.from_numpy(vl))
    SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab)).sum().backward()
    return {n: p.grad.numpy() for n, p in tm.named_parameters()
            if p.grad is not None}


def test_every_gradient_matches_jax_amp(ref):
    tm = _port(ref["params"])
    _amp_step(tm)
    grads, f32 = ref["grads"], _f32_grads(ref["params"])
    for name, p in tm.named_parameters():
        want = grads.get(name)
        if p.grad is None:       # not reached by the MLM loss
            assert want is None or not onp.abs(want).any(), name
            continue
        assert p.grad.dtype == torch.float32, name
        tol = max(GRAD_TIMES * _rel(want, f32[name]), GRAD_FLOOR)
        assert _rel(p.grad.numpy(), want) <= tol, name


def test_adam_step_matches_jax_amp_trainer(ref):
    tm = _port(ref["params"])
    _amp_step(tm)
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()
             if p.grad is not None}
    Trainer(tm.collect_params(), Adam(learning_rate=LR)).step(3)
    agree = total = 0
    for name, p in tm.named_parameters():
        got, want = p.detach().numpy(), ref["stepped"][name]
        g_ref = ref["grads"].get(name)
        if name not in grads:
            onp.testing.assert_array_equal(got, want, err_msg=name)
            continue
        g = grads[name].numpy()
        # the step sees the gradient rescaled by 1 / batch size
        same = ((onp.sign(g) == onp.sign(g_ref))
                & (onp.abs(g) / 3 >= ADAM_G) & (onp.abs(g_ref) / 3 >= ADAM_G))
        onp.testing.assert_allclose(got[same], want[same], rtol=0,
                                    atol=ADAM_TOL, err_msg=name)
        assert (onp.abs(got - want) <= 2 * LR * (1 + 1e-5)).all(), name
        agree += int((onp.sign(g) == onp.sign(g_ref)).sum())
        total += g.size
    assert agree >= SIGN_AGREE * total


def test_scaled_step_equals_unscaled_step(ref):
    """scale_loss multiplies the loss by the loss scale (2^16) and folds
    its inverse into Trainer._scale, so the step is the same, bit for bit;
    unscale resets _scale."""
    stepped, scales = [], []
    for scaled in (False, True):
        tm = _port(ref["params"])
        trainer = Trainer(tm.collect_params(), Adam(learning_rate=LR))
        tok, lab, vl = _data()
        amp.init("bfloat16")
        try:
            mlm, _ = tm(torch.from_numpy(tok).long(),
                        valid_length=torch.from_numpy(vl))
            loss = SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab))
            if scaled:
                with amp.scale_loss(loss.sum(), trainer) as big:
                    assert torch.equal(big, loss.sum() * 2.0 ** 16)
                    big.backward()
            else:
                loss.sum().backward()
        finally:
            amp.deinit()
        scales.append(trainer._scale)
        trainer.step(3)
        stepped.append([p.detach().clone() for p in tm.parameters()])
        amp.unscale(trainer)
        assert trainer._scale == 1.0
    assert scales == [1.0, 2.0 ** -16]
    assert trainer.optimizer.rescale_grad == 2.0 ** -16 / 3
    assert all(torch.equal(a, b) for a, b in zip(*stepped))


@pytest.mark.parametrize("flags", [
    [False] * 5, [True, False, False, True], [False, True] * 3,
    [True] * 20, [False] * 3 + [True] + [False] * 4])
def test_loss_scaler_update_matches_the_reference(flags):
    ours = amp.LossScaler(init_scale=2.0 ** 4, scale_window=3,
                          min_scale=0.5)
    theirs = jamp.LossScaler(init_scale=2.0 ** 4, scale_window=3,
                             min_scale=0.5)
    for overflow in flags:
        ours.update_scale(overflow)
        theirs.update_scale(overflow)
        assert ours.loss_scale == theirs.loss_scale
        assert ours._unskipped == theirs._unskipped
    assert amp.LossScaler().loss_scale == jamp.LossScaler().loss_scale


class _RefParam:
    """What the reference's has_overflow reads of a parameter."""

    def __init__(self, grad):
        self._grad = None if grad is None else np.array(grad)

    def data(self):
        return self


@pytest.mark.parametrize("bad", [None, onp.inf, -onp.inf, onp.nan])
def test_has_overflow_matches_the_reference(bad):
    r = onp.random.RandomState(4)
    grads = [r.normal(0, 1, (5, 3)).astype("float32"), None,
             r.normal(0, 1, (7,)).astype("float32")]
    if bad is not None:
        grads[2][4] = bad
    params = []
    for g in grads:
        p = torch.zeros(3 if g is None else g.shape, requires_grad=True)
        p.grad = None if g is None else torch.from_numpy(g)
        params.append(p)
    want = jamp.LossScaler().has_overflow([_RefParam(g) for g in grads])
    assert amp.LossScaler().has_overflow(params) == want == (bad is not None)
    assert not amp.LossScaler().has_overflow([torch.zeros(2)])


def test_convert_model_matches_jax(ref):
    tok, _, vl = _data()
    jm = jamp.convert_model(_jax_model(ref["params"]), "bfloat16")
    want, _ = jm(np.array(tok), None, np.array(vl))
    tm = amp.convert_model(_port(ref["params"]).eval(), "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(tok).long(),
                    valid_length=torch.from_numpy(vl))
    assert got.dtype == torch.bfloat16 and _dt(want) == "bfloat16"
    assert _rel(got.float().numpy(), onp.asarray(want.asnumpy(),
                                                 onp.float32)) \
        <= CONVERT_ALL_TOL


def test_convert_hybrid_block_matches_jax(ref):
    tok, _, vl = _data()
    jw = jamp.convert_hybrid_block(_jax_model(ref["params"]), "bfloat16")
    want, _ = jw(np.array(tok), None, np.array(vl))
    tm = _port(ref["params"]).eval()
    tw = amp.convert_hybrid_block(tm, "bfloat16")
    kept = {n for n, p in tm.named_parameters() if p.dtype == torch.float32}
    assert kept == {n for n in ref["params"] if n.endswith(("gamma", "beta"))
                    or n == "encoder.position_embed"}
    with torch.no_grad():
        got, _ = tw(torch.from_numpy(tok).long(), None,
                    torch.from_numpy(vl))
    assert not amp.amp_active()
    assert got.dtype == torch.float32 and _dt(want) == "float32"
    assert _rel(got.numpy(), want.asnumpy()) <= CONVERT_TOL


def test_deinit_restores_the_float32_path_bitwise(ref):
    """The f32 step before AMP, and after an AMP step and deinit, give the
    same scores and gradients bit for bit."""
    tok, lab, vl = _data()

    def f32_step():
        tm = _port(ref["params"])
        mlm, _ = tm(torch.from_numpy(tok).long(),
                    valid_length=torch.from_numpy(vl))
        SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab)).sum(
        ).backward()
        return [mlm.detach()] + [p.grad for p in tm.parameters()]

    before = f32_step()
    _amp_step(_port(ref["params"]))
    assert not amp.amp_active()
    after = f32_step()
    assert before[0].dtype == torch.float32
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(before, after))


def test_init_takes_bfloat16_only():
    """The default target is bfloat16; float16 is taken too (the float16
    kernels), any other target raises ValueError, as in the reference."""
    amp.init("float16")
    try:
        assert amp.amp_active() and amp.amp_dtype() == torch.float16
    finally:
        amp.deinit()
    assert not amp.amp_active()
    with pytest.raises(ValueError):
        amp.init("int8")
    with pytest.raises(ValueError):
        amp.convert_model(torch.nn.Linear(2, 2), "int8")
    amp.init()
    try:
        assert amp.amp_active() and amp.amp_dtype() == torch.bfloat16
        assert amp.op_cast_mode("fully_connected") == ("target", "bfloat16")
        assert amp.op_cast_mode("softmax") == ("fp32",)
        assert amp.op_cast_mode("layer_norm") is None
        x, i = torch.ones(2), torch.ones(2, dtype=torch.long)
        cx, ci, none = amp.cast_inputs("embedding", x, i, None)
        assert cx.dtype == torch.bfloat16 and ci is i and none is None
        assert amp.cast_inputs("activation", x)[0] is x
        assert amp.cast_for_matmul(x)[0].dtype == torch.bfloat16
    finally:
        amp.deinit()
    assert amp.cast_inputs("embedding", x)[0] is x
    assert amp.lists.TARGET_DTYPE_OPS == jamp.lists.TARGET_DTYPE_OPS
    assert amp.lists.FP32_OPS == jamp.lists.FP32_OPS
