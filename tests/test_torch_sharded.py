"""The port's mesh paths of training (`parallel.DataParallel(mesh=,
param_shardings=)`, BERT's ``seq_shard_axis``, `rebuild`, the ambient
`mesh_scope`, `models.sharded_bert`) against the JAX package's, on
`bert_small` (vocab 64, max_length 32, batch 8 × 16).

One 4-rank gloo world (`torch_worlds/sharded.py`) runs every case; the
JAX oracles run here on 4 of the 8 virtual CPU devices, from the same
weights (the JAX net's parameters, rescaled to N(0, 0.2) where 2-D, and
the JAX `sharded_bert.init_params`, both through numpy):

- `test_parallel.py:298`'s case: dp = 2 × tp = 2 with the Megatron specs
  and SP at dropout 0, SGD lr 0.1, 3 steps, against the JAX DataParallel
  on a (2, 2) mesh and against the port's replicated run on dp = 4, at
  that test's tolerances (losses 2e-4; parameters rtol 3e-3, atol 3e-4);
- the ambient `mesh_scope`, and `rebuild` from dp = 4 onto dp × tp with
  the momentum carried (SGD, momentum 0.9; against 3 steps on dp × tp:
  1e-5, the same sums in other orders);
- `sharded_bert.make_train_step` (float32, Adam lr 1e-3, SP) against the
  JAX one, at `test_torch_parallel.py`'s tolerances: losses 1e-4, and
  parameters 1e-6 except where a step's gradient is near zero (within 10
  × 1e-4 of the leaf's largest), where Adam's lr·sign(g) may flip and
  the parameter is held to the steps' bound, lr a step;
- the tp replicas hold the same bits, at p = 0 and at p = 0.1;
- the dropout keys under sharding: replicated sites draw the same mask
  on the tp ranks and another on each dp rank, a sequence-parallel
  site's blocks draw different masks, each step draws a fresh one.
"""
import os
import pickle
import sys

import numpy as onp
import pytest

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import np as jnp_mx
from incubator_mxnet_tpu import optimizer as joptimizer
from incubator_mxnet_tpu.models import sharded_bert as jsb
from incubator_mxnet_tpu.models.bert import bert_small as jbert_small
from incubator_mxnet_tpu.models.bert import (
    tp_param_shardings as jtp_param_shardings,
)
from incubator_mxnet_tpu.parallel import DataParallel as JDataParallel
from incubator_mxnet_tpu.parallel import make_mesh as jmake_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402
from torch_worlds.sharded import VOCAB, batch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SB_CFG = dict(vocab_size=96, units=64, hidden_size=128, num_layers=2,
              num_heads=4, max_length=32, dtype="float32")
SB_LR, STEPS = 1e-3, 3


def _jax_bert():
    jmx.random.seed(7)
    net = jbert_small(vocab_size=VOCAB, max_length=32, dropout=0.0,
                      seq_shard_axis="tp")
    net.initialize()
    r = onp.random.RandomState(1)
    for _n, p in net.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(jnp_mx.array(r.normal(0, 0.2, p.shape)
                                    .astype("float32")))
    return net


def _jax_tp_run(net):
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()

    def mlm_loss(out, y):
        return ce(out[0].reshape(-1, VOCAB), y.reshape(-1))

    mesh = jmake_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    dp = JDataParallel(net, mlm_loss, joptimizer.SGD(learning_rate=0.1),
                       mesh=mesh, param_shardings=jtp_param_shardings(net))
    tok, lab = (t.numpy().astype("int32") for t in batch())
    losses = [float(dp.step(jnp_mx.array(tok), jnp_mx.array(lab)).asnumpy())
              for _ in range(STEPS)]
    return losses, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}


def _jax_sharded_bert(batch_):
    """The JAX sharded step's losses and parameters after each step, and
    each step's gradient at the parameters it started from (its
    parameters are `init_params(cfg)`'s)."""
    cfg = jsb.BertConfig(**SB_CFG)
    mesh = jmake_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    step, params, st = jsb.make_train_step(cfg, mesh, lr=SB_LR, use_sp=True)
    tok, lab = batch_
    grad = jax.jit(jax.grad(lambda p: jsb.loss_fn(p, tok, lab, cfg)))
    P = jax.sharding.PartitionSpec
    specs = jsb.param_specs(cfg)

    def placed(tree):
        # the step's outputs come back in the compiler's layouts, which
        # its next call refuses: place them by the specs again
        return jax.tree.map(
            lambda v, sp: jax.device_put(
                onp.asarray(v), jax.sharding.NamedSharding(mesh, sp)),
            tree, specs, is_leaf=lambda x: isinstance(x, P))

    losses, grads = [], []
    for _ in range(STEPS):
        grads.append(jax.tree.map(onp.asarray, grad(jax.tree.map(
            jnp.asarray, jax.tree.map(onp.asarray, params)))))
        loss, params, st = step(params, st, tok, lab)
        params = placed(params)
        st = {"m": placed(st["m"]), "v": placed(st["v"]), "t": st["t"]}
        losses.append(float(loss))
    return losses, jax.tree.map(onp.asarray, params), grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    net = _jax_bert()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    cfg = jsb.BertConfig(**SB_CFG)
    sb_init = jax.tree.map(onp.asarray, jsb.init_params(cfg))
    r = onp.random.RandomState(3)
    sb_batch = tuple(r.randint(0, cfg.vocab_size, (8, 16)).astype("int32")
                     for _ in range(2))
    tmp = tmp_path_factory.mktemp("sharded_world")
    inp = tmp / "input.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"bert": params, "cfg": SB_CFG, "sb_params": sb_init,
                     "sb_batch": sb_batch}, f)
    # the world runs while the JAX oracles compute
    w = world.World(os.path.join(HERE, "torch_worlds", "sharded.py"), 4, tmp,
                    env={"MX_CASE_INPUT": str(inp)})
    jlosses, jparams = _jax_tp_run(net)
    sb_losses, sb_params, sb_grads = _jax_sharded_bert(sb_batch)
    return {"ranks": w.results(), "jlosses": jlosses, "jparams": jparams,
            "sb": (sb_losses, sb_params, sb_grads), "params": params}


def _np(t):
    return t.detach().numpy() if hasattr(t, "detach") else onp.asarray(t)


def test_tp_sp_matches_jax_data_parallel(run):
    jl, jp = run["jlosses"], run["jparams"]
    for r in run["ranks"]:
        onp.testing.assert_allclose(r["tp_losses"], jl, rtol=2e-4, atol=2e-4)
        for n, want in jp.items():
            onp.testing.assert_allclose(_np(r["tp_params"][n]), want,
                                        rtol=3e-3, atol=3e-4, err_msg=n)
    assert jl[-1] < jl[0]


def test_tp_sp_matches_the_replicated_run(run):
    for r in run["ranks"]:
        onp.testing.assert_allclose(r["tp_losses"], r["rep_losses"],
                                    rtol=2e-4, atol=2e-4)
        for n, want in r["rep_params"].items():
            onp.testing.assert_allclose(_np(r["tp_params"][n]), _np(want),
                                        rtol=3e-3, atol=3e-4, err_msg=n)


def test_blocks_follow_the_specs(run):
    """The optimizer's blocks are the specs' cut: qkv (192, 64) by rows,
    proj (64, 64) by columns, the vocabulary of 64 in halves; and the
    step splits BERT's compute over tp (Megatron's path)."""
    b = run["ranks"][0]["blocks"]
    assert all(r["tp_axis"] == "tp" for r in run["ranks"])  # the TP path
    assert b["encoder.layers.0.attention.qkv.weight"] == (96, 64)
    assert b["encoder.layers.0.attention.proj.weight"] == (64, 32)
    assert b["encoder.word_embed.weight"] == (32, 64)
    assert b["mlm_decoder.bias"] == (32,)
    assert b["encoder.ln.gamma"] == (64,)


@pytest.mark.parametrize("key", ["tp_params", "p01_params"])
def test_tp_replicas_hold_the_same_bits(run, key):
    r = run["ranks"]
    for a, b in ((0, 1), (2, 3), (0, 2)):
        for n, t in r[a][key].items():
            assert (_np(t) == _np(r[b][key][n])).all(), (key, n, a, b)


def test_load_jax_params_into_a_sharded_net(run):
    """`load_jax_params` on a net `DataParallel` has sharded: each rank's
    blocks are its blocks of the loaded weights (rank r: dp r // 2, tp
    r % 2)."""
    import torch

    src = run["params"]
    for r in run["ranks"]:
        tp = r["rank"] % 2
        for n, blk in r["loaded_blocks"].items():
            want = torch.from_numpy(src[n])
            if n.endswith(("qkv.weight", "qkv.bias", "ffn1.weight",
                           "ffn1.bias", "word_embed.weight",
                           "mlm_decoder.weight", "mlm_decoder.bias")):
                want = want.chunk(2, dim=0)[tp]
            elif n.endswith(("proj.weight", "ffn2.weight")):
                want = want.chunk(2, dim=1)[tp]
            assert torch.equal(blk, want), n


def test_uneven_vocabulary_shards(run):
    """A vocabulary of 97 over tp = 2 (blocks of 49 and 48, as GSPMD pads
    them; the JAX package cannot place it): TP + SP against the port's
    replicated run, at the same tolerances."""
    for r in run["ranks"]:
        assert r["uneven_block"] == (49 if r["rank"] % 2 == 0 else 48, 64)
        onp.testing.assert_allclose(r["uneven_tp"][0], r["uneven_rep"][0],
                                    rtol=2e-4, atol=2e-4)
        for n, want in r["uneven_rep"][1].items():
            onp.testing.assert_allclose(_np(r["uneven_tp"][1][n]),
                                        _np(want), rtol=3e-3, atol=3e-4,
                                        err_msg=n)


def test_ambient_mesh_scope(run):
    for r in run["ranks"]:
        assert r["ambient_mesh"]
        assert r["ambient_losses"] == r["tp_losses"]


def test_rebuild_carries_params_and_optimizer_state(run):
    for r in run["ranks"]:
        assert r["rebuild_t"] == 4
        onp.testing.assert_allclose(r["rebuild_losses"],
                                    r["straight_losses"], rtol=1e-5,
                                    atol=1e-5)
        for n, want in r["straight_params"].items():
            onp.testing.assert_allclose(_np(r["rebuild_params"][n]),
                                        _np(want), rtol=1e-5, atol=1e-5,
                                        err_msg=n)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_sharded_bert_step_matches_jax(run):
    losses, params, grads = run["sb"]
    for r in run["ranks"]:
        assert r["sb_block_qkv"] == (64, 96)     # (in, 3C / tp)
        onp.testing.assert_allclose(r["sb_losses"], losses, rtol=1e-4,
                                    atol=1e-4)
        got = _leaves(r["sb_params"])
        for i, want in enumerate(_leaves(params)):
            g = [onp.abs(_leaves(s)[i]) for s in grads]
            near = onp.zeros(want.shape, bool)
            for a in g:
                near |= a <= 10 * 1e-4 * max(float(a.max()), 1e-30)
            diff = onp.abs(_np(got[i]) - want)
            assert (diff[~near] <= 1e-6 + 1e-6 * onp.abs(want[~near])).all(), i
            assert (diff[near] <= 2 * SB_LR * STEPS + 1e-6).all(), i


def test_dropout_keys_under_sharding(run):
    r = run["ranks"]
    m = [x["probe_masks"] for x in r]
    for step in range(2):
        rep = [_np(m[k][step][0]) for k in range(4)]
        sp = [_np(m[k][step][1]) for k in range(4)]
        # replicas on the tp ranks draw the same mask, data shards others
        assert (rep[0] == rep[1]).all() and (rep[2] == rep[3]).all()
        assert (rep[0] != rep[2]).any()
        # a sequence-parallel site: gathered whole, the same on the tp
        # pair; its two blocks were drawn with different keys
        assert (sp[0] == sp[1]).all()
        assert (sp[0][:, :3] != sp[0][:, 3:]).any()
        assert (sp[0] != sp[2]).any()
        for a in rep + sp:
            assert 0.3 < a.mean() < 0.7
    assert (_np(m[0][0][0]) != _np(m[0][1][0])).any()   # a fresh mask


def test_sp_sums_its_shares_once_a_step(run):
    """A TP + SP step of bert_small (2 layers) exchanges 11 times more
    than TP alone (16 a step): Megatron SP puts an all-gather and a
    reduce-scatter where TP has one all-reduce at each region's entry and
    exit, 4 more a layer; the embedding's exit is a reduce-scatter (its
    gradient an all-gather) where TP has one all-reduce; the encoder's
    rows are gathered once for the heads; and one all-reduce sums every
    region's shares (γ/β, the biases and embeddings added on the rows)."""
    for r in run["ranks"]:
        assert r["exchanges"]["None"] == 16
        assert r["exchanges"]["tp"] - r["exchanges"]["None"] == 11


def test_sp_region_outside_a_step(run):
    """A sequence-parallel region's parameters get this rank's shares of
    their gradients: differentiated outside a step that sums them, the
    region raises; under no_grad it runs."""
    for r in run["ranks"]:
        assert "sequence-parallel region" in r["outside_step"]
        assert r["outside_no_grad"] == (8, 16, VOCAB)


def test_workers_import_no_jax(run):
    assert all(r["forbidden"] == [] for r in run["ranks"])


def _cut_names(n):
    return n.endswith(("qkv.weight", "qkv.bias", "ffn1.weight", "ffn1.bias",
                       "proj.weight", "ffn2.weight", "word_embed.weight",
                       "mlm_decoder.weight", "mlm_decoder.bias"))


def test_each_rank_stores_only_its_blocks(run):
    """Storage by the spec: every cut parameter's tensor is the rank's
    block of its whole shape (no whole copy kept), and each rank's bytes
    of parameters, of the gradients a step applies and of Adam's state,
    counted from its tensors, are the whole model's less half of every
    cut parameter's."""
    for r in run["ranks"]:
        shapes = r["stored_shapes"]
        whole = sum(int(onp.prod(w)) for _s, w in shapes.values()) * 4
        stored = sum(int(onp.prod(s)) for s, _w in shapes.values()) * 4
        cut = sum(int(onp.prod(w)) for n, (_s, w) in shapes.items()
                  if _cut_names(n)) * 4
        for n, (s, w) in shapes.items():
            if not _cut_names(n):
                assert s == w, n
            elif len(w) == 1:
                assert s[0] * 2 == w[0], n
            else:
                d = 1 if n.endswith(("proj.weight", "ffn2.weight")) else 0
                assert s[d] * 2 == w[d] and s[1 - d] == w[1 - d], n
        assert stored == whole - cut // 2
        assert r["bytes_counted_whole"] == whole
        assert r["bytes_counted_spec"] == stored
        spec, full = r["bytes_spec"], r["bytes_whole"]
        assert full == {"params": whole, "grads": whole,
                        "optimizer": 2 * whole}
        assert spec == {"params": stored, "grads": stored,
                        "optimizer": 2 * stored}
        assert stored < 0.75 * whole


def test_qkv_head_exchange_against_the_whole_weight(run):
    """`_layout.head_rows` gives each rank its heads' rows of a fused
    [q|k|v] projection whose spec cuts its rows contiguously, and sends
    their gradient back into the stored block: against the whole tensor's
    rows and the whole gradient's block, bit for bit (the whole-weight
    step it replaces is held against the JAX package's by
    test_tp_sp_matches_jax_data_parallel)."""
    for r in run["ranks"]:
        assert r["heads"] == (True, True)


@pytest.mark.parametrize("rule", ["lamb", "lans", "lars"])
def test_per_tensor_norms_on_cut_parameters(run, rule):
    """LAMB, LANS and LARS update cut parameters by blocks with each norm
    summed over the cut axes (tp, and dp for a weight cut over the data
    axis, whose gradient is reduce-scattered): against the no-mesh step
    at rtol 1e-5."""
    for r in run["ranks"]:
        (l0, p0), (l1, p1) = r["norm_rules"][rule]
        onp.testing.assert_allclose(l1, l0, rtol=1e-5, atol=1e-7)
        for n, want in p0.items():
            onp.testing.assert_allclose(_np(p1[n]), _np(want), rtol=1e-5,
                                        atol=1e-7, err_msg=n)
        assert l0[-1] < l0[0]


def test_sp_keeps_the_stream_cut_between_regions(run):
    """Megatron SP: the embedding's LayerNorm and every post-LN site of a
    TP + SP step see the rank's rows of the sequence only (4 rows of the
    batch a dp rank, 8 of 16 positions a tp rank), and the step's loss is
    the replicated run's."""
    for r in run["ranks"]:
        seen, losses = r["sp_cut"]
        assert len(seen) == 5                  # the embedding + 2 x 2 sites
        assert all(s == ((4, 8, 64), True) for s in seen), seen
        onp.testing.assert_allclose(losses, r["rep_losses"][:1], rtol=2e-4,
                                    atol=2e-4)
