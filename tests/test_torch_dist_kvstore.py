"""The port's multi-process runtime and kvstores (`parallel.dist`,
`kvstore/`, `gluon.Trainer(kvstore=...)`) against the JAX package's.

One world: `tools/launch.py` (unchanged) starts 3 port workers
(`torch_worlds/dist_kvstore.py`) on a free port it is given; they join a
gloo world from the reference's environment names and check
`tests/test_kvstore_dist.py`'s exact cross-process sums, the host-level
API, ``Trainer(kvstore="dist_sync")`` against one process on the joined
batch (within 1e-6: the same sums in another order), and the membership
epochs (a departure settles, a stale or departed rank raises
`StaleGenerationError` before the transport, a rejoin widens the roster,
a rank that missed a transition raises). The in-process cases are
`test_kvstore_backends.py`'s five and `test_parallel.py:162`'s API on
the port, and 2-bit compression against the reference's on the same
gradients (exact: the same thresholds and residuals).
"""
import os
import socket
import subprocess
import sys
import warnings

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import np as jnp_mx
from incubator_mxnet_tpu.kvstore import compression as jcomp

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, kv, np
from incubator_mxnet_tpu_torch.kvstore import compression as tcomp
from incubator_mxnet_tpu_torch.kvstore.base import KVStoreBase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_worlds", "dist_kvstore.py")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_world")
    env = dict(os.environ, MX_WORLD_OUT=str(out), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n", "3",
         "--port", str(_free_port()), sys.executable, WORKER],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    for r in range(3):
        assert f"worker {r} ok" in res.stdout
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(3)]


# -- the world through tools/launch.py ----------------------------------------
def test_exact_cross_process_sums(ranks):
    for r in ranks:
        assert r["n"] == 3 and r["backend"] == "gloo"
        onp.testing.assert_array_equal(r["pushpull"], onp.full(4, 6.0))
        onp.testing.assert_array_equal(r["init"], onp.full(3, 7.0))
        onp.testing.assert_allclose(r["push"], onp.full(3, 7.0 - 0.6),
                                    rtol=1e-6)


def test_host_level_api(ranks):
    for r in ranks:
        assert int(r["allreduce_max"]) == 2
        assert float(r["broadcast"]) == 11.0
        assert r["exchange"] == [{"r": 0}, {"r": 1}, {"r": 2}]


def test_trainer_dist_sync_equals_one_process(ranks):
    for r in ranks:
        for got, want in zip(r["trainer_dist"], r["trainer_one"]):
            onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    onp.testing.assert_array_equal(ranks[0]["trainer_dist"][0],
                                   ranks[1]["trainer_dist"][0])


def test_membership_epochs(ranks):
    r0, r1, r2 = ranks
    assert r2["leave"] == (1, ())
    assert "outside the membership" in r2["stale_departed"]
    for r in (r0, r1):
        assert r["departures"] == (2,)
        assert r["settled"] == (1, (0, 1))
        assert float(r["survivors_sum"]) == 3.0
        assert r["rejoins"] == (2,)
    assert "superseded epoch" in r1["stale_generation"]
    for r in ranks:
        assert r["rejoined"] == (2, (0, 1, 2))
        assert float(r["all_sum"]) == 6.0
    for r in (r0, r1):
        assert r["shrunk"] == (3, (0, 1))
        assert float(r["shrunk_sum"]) == 3.0
    assert "newer membership epoch" in r2["stale_missed"]


def test_workers_import_no_jax(ranks):
    assert all(r["forbidden"] == [] for r in ranks)


# -- in process ---------------------------------------------------------------
def test_kvstore_api():
    """`test_parallel.py:162`'s case on the port."""
    store = mx.kv.create("device")
    store.init("w", np.ones((3,)))
    out = np.zeros((3,))
    store.pull("w", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.ones(3))
    store.pushpull("g", np.full((3,), 2.0), out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full(3, 2.0))
    assert store.rank == 0 and store.num_workers == 1
    store.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    store.init("p", np.ones((2,)))
    store.push("p", np.full((2,), 1.0))
    pulled = np.zeros((2,))
    store.pull("p", out=pulled)
    onp.testing.assert_allclose(pulled.asnumpy(), onp.full(2, 0.9),
                                rtol=1e-5)


@KVStoreBase.register
class HorovodLike(KVStoreBase):
    """`test_kvstore_backends.py`'s out-of-tree backend, on the port."""

    def __init__(self):
        self.pushpull_calls = 0

    def broadcast(self, key, value, out):   # noqa: ARG002
        outs = out if isinstance(out, (list, tuple)) else [out]
        src = value if not isinstance(value, (list, tuple)) else value[0]
        for o in outs:
            o._set_data(src._data)

    def pushpull(self, key, value, out=None, priority=0):  # noqa: ARG002
        self.pushpull_calls += 1
        vs = value if isinstance(value, (list, tuple)) else [value]
        acc = vs[0].asnumpy()
        for v in vs[1:]:
            acc = acc + v.asnumpy()
        red = np.array(acc)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for o in outs if out is not None else [vs[0]]:
            o._set_data(red._data)

    @staticmethod
    def is_capable(capability):  # noqa: ARG004
        return False


def test_custom_backend_create_and_roundtrip():
    store = kv.create("horovodlike")
    assert isinstance(store, HorovodLike)
    assert store.num_workers == 1 and store.rank == 0
    assert not store.is_capable(KVStoreBase.OPTIMIZER)
    a = np.array(onp.ones((4, 4), "float32"))
    b = np.array(onp.full((4, 4), 2.0, "float32"))
    out = np.array(onp.zeros((4, 4), "float32"))
    store.pushpull("w0", [a, b], out=out)
    onp.testing.assert_allclose(out.asnumpy(), 3.0 * onp.ones((4, 4)))
    assert store.pushpull_calls == 1
    dst = np.array(onp.zeros((4, 4), "float32"))
    store.broadcast("w0", a, dst)
    onp.testing.assert_allclose(dst.asnumpy(), a.asnumpy())


def test_trainer_runs_on_custom_backend():
    net = gluon.nn.Dense(4, in_units=8, device="cpu")
    net.initialize(device="cpu")
    store = kv.create("horovodlike")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore=store,
                            update_on_kvstore=False)
    x = np.array(onp.random.RandomState(0).uniform(-1, 1, (16, 8))
                 .astype("float32"))
    w_before = net.weight.data().asnumpy().copy()
    with autograd.record():
        loss = (net(x) ** 2).mean()
    loss.backward()
    trainer.step(16)
    assert store.pushpull_calls == 2        # weight and bias
    assert not onp.allclose(net.weight.data().asnumpy(), w_before)


def test_kvstore_device_identity_reduce_contract():
    store = kv.create("device")
    single = np.array(onp.full((3, 3), 5.0, "float32"))
    onp.testing.assert_array_equal(store._reduce(single).asnumpy(),
                                   single.asnumpy())
    store.init("k", np.array(onp.zeros((3, 3), "float32")))
    copies = [np.array(onp.full((3, 3), float(i), "float32"))
              for i in (1, 2, 4)]
    out = np.array(onp.zeros((3, 3), "float32"))
    store.pushpull("k", copies, out=out)
    onp.testing.assert_allclose(out.asnumpy(), 7.0 * onp.ones((3, 3)))


def test_dist_async_warns_sync_degradation():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        store = kv.create("dist_async")
    assert any("synchronous" in str(x.message) for x in w)
    assert store.num_workers == 1       # no world: one process


def test_horovod_local_rank_env(monkeypatch):
    store = kv.create("horovod")
    monkeypatch.setenv("MXNET_LOCAL_RANK", "3")
    assert store.local_rank == 3
    for name in ("MXNET_LOCAL_RANK", "HOROVOD_LOCAL_RANK",
                 "OMPI_COMM_WORLD_LOCAL_RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert store.local_rank == store.rank == 0
    with pytest.raises(NotImplementedError):
        store.pull("k")


@pytest.mark.parametrize("ctype,threshold", [("2bit", 0.5), ("2bit", 0.1),
                                             ("fp16", 0.5)])
def test_compression_matches_reference(ctype, threshold):
    r = onp.random.RandomState(2)
    grads = [r.normal(0, 0.4, (5, 7)).astype("float32") for _ in range(4)]
    jc = jcomp.create({"type": ctype, "threshold": threshold})
    tc = tcomp.create({"type": ctype, "threshold": threshold})
    for g in grads:
        want = jc.compress("k", jnp_mx.array(g)).asnumpy()
        got = tc.compress("k", np.array(g)).asnumpy()
        onp.testing.assert_array_equal(got, want)
    if ctype == "2bit":
        onp.testing.assert_allclose(tc._residual["k"].numpy(),
                                    onp.asarray(jc._residual["k"]),
                                    rtol=0, atol=1e-7)


def test_trainer_compression_on_a_local_store():
    """``compression_params`` compress the push leg: a 2-bit store hands
    the optimizer only ±threshold or 0, carrying the rest over."""
    net = gluon.nn.Dense(2, in_units=3, use_bias=False, device="cpu")
    net.initialize(device="cpu")
    w0 = net.weight.data().asnumpy().copy()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0},
                       kvstore="local",
                       compression_params={"type": "2bit", "threshold": 0.5})
    x = np.array(onp.ones((1, 3), "float32"))
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr.step(1)
    step = w0 - net.weight.data().asnumpy()
    assert set(onp.unique(onp.round(step, 6)).tolist()) <= {0.0, 0.5, -0.5}
    with pytest.raises(ValueError, match="compression"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore=HorovodLike(),
                      compression_params={"type": "2bit"}).step(1)


def test_reference_and_port_accept_the_same_types():
    for name in ("local", "device", "nccl", "dist_sync", "dist_device_sync",
                 "horovod", "byteps"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = type(kv.create(name)).__name__
            j = type(jmx.kv.create(name)).__name__
        assert t == j, name
    with pytest.raises(ValueError, match="unknown KVStore"):
        kv.create("nope")
