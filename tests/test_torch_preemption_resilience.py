"""`preemption` and `fault.resilience` of the port against the JAX
package's, on the CPU: the preemption hooks (``trigger()``, SIGTERM
chained to the previous handler), `atomic_save` (the checksum and layout
sidecars byte for byte the reference's, the retry under the
``checkpoint_write`` chaos seam, no partial file on failure),
`CheckpointManager`'s rotation, `TrainingCheckpointer` (a resume bit for
bit, the fallback past a corrupt generation, a checkpoint the reference
wrote resumed by the port, a layout from another device count refused),
`CheckpointHandler`'s resume, and `ResilienceHandler`'s veto of a
non-finite step and its resume after a crash injected at the
``estimator_step`` seam, each fit against the reference's fit under the
same schedule.

Tolerances: files, sidecars, resumed parameters and optimizer states
bit for bit; a fit's final parameters within 1e-5 of their largest
magnitude (float32, a one-layer net, the same arithmetic in another
order).
"""
import os
import signal

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import preemption as jpre
from incubator_mxnet_tpu_torch import preemption as tpre
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    tpre.clear_preemption_hooks()
    jpre.clear_preemption_hooks()


def test_trigger_runs_hooks_and_sets_preempted():
    calls = []
    for pre in (tpre, jpre):
        pre.clear_preemption_hooks()
        a = pre.on_preemption(lambda: calls.append("a"))
        pre.on_preemption(lambda: calls.append("b"))
        pre.on_preemption(lambda: 1 / 0)        # logged, not raised
        assert not pre.preempted()
        pre.remove_preemption_hook(a)
        pre.trigger()
        assert pre.preempted()
        pre.clear_preemption_hooks()
        assert not pre.preempted()
    assert calls == ["b", "b"]


def test_sigterm_runs_the_hooks_then_the_previous_handler():
    seen = []
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    saved = dict(tpre._STATE, prev=dict(tpre._STATE["prev"]))
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(("prev", s)))
    tpre._STATE.update(installed=False, prev={})
    try:
        tpre.on_preemption(lambda: seen.append("hook"))
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == ["hook", ("prev", signal.SIGTERM)]
        assert tpre.preempted()
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        tpre._STATE.clear()
        tpre._STATE.update(saved)


def _write_bytes(data):
    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)
    return write


def test_atomic_save_files_equal_the_references(tmp_path):
    data = onp.random.RandomState(0).bytes(3000)
    layout = {"format": 1, "device_count": 1, "process_count": 1,
              "generation": 0}
    out = {}
    for name, pre in (("port", tpre), ("ref", jpre)):
        path = str(tmp_path / f"{name}.bin")
        pre.atomic_save(path, _write_bytes(data), layout=layout)
        out[name] = [open(path + s, "rb").read()
                     for s in ("", ".crc32", ".layout.json")]
        assert tpre.verify_checkpoint(path) is True
        assert jpre.verify_checkpoint(path) is True
        assert tpre.load_layout(path) == layout
    assert out["port"] == out["ref"]
    rt = tpre._runtime_layout()
    assert sorted(rt) == ["device_count", "format", "generation",
                          "process_count"]
    assert rt["format"] == 1 and rt["process_count"] == 1 \
        and rt["generation"] == 0


def test_atomic_save_retries_the_chaos_seam_and_leaves_no_partial(tmp_path):
    from incubator_mxnet_tpu_torch.fault import injection

    path = str(tmp_path / "c.bin")
    tpre.atomic_save(path, _write_bytes(b"old"))
    injection.configure_injection("checkpoint_write:1.0:0:1")
    try:
        tpre.atomic_save(path, _write_bytes(b"new"))
    finally:
        injection.clear_injection()
    assert open(path, "rb").read() == b"new"

    def broken(tmp):
        with open(tmp, "wb") as f:
            f.write(b"partial")
        raise ValueError("a writer bug")

    with pytest.raises(ValueError):
        tpre.atomic_save(path, broken)
    assert open(path, "rb").read() == b"new"
    assert sorted(os.listdir(tmp_path)) == ["c.bin", "c.bin.crc32"]


def test_checkpoint_manager_rotates_as_the_reference(tmp_path):
    got = {}
    for name, pre in (("port", tpre), ("ref", jpre)):
        d = tmp_path / name
        d.mkdir()
        mgr = pre.CheckpointManager(str(d / "m"), _write_bytes(b"x"),
                                    every_n=2, keep=2)
        for _ in range(7):
            mgr.step()
        assert mgr.save_now() is not None and mgr.save_now() is None
        pre.trigger()                     # the hook: already saved
        got[name] = (sorted(os.listdir(d)),
                     os.path.basename(mgr.latest()),
                     [os.path.basename(p) for p in mgr.generations()])
    assert got["port"] == got["ref"]
    assert got["port"][1] == "m-0000007.ckpt"


def _dense_pair(seed=0):
    """A port Dense(3) on 4 inputs with an Adam Trainer, seeded."""
    r = onp.random.RandomState(seed)
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    net.weight.set_data(r.normal(size=(3, 4)).astype("float32"))
    net.bias.set_data(r.normal(size=3).astype("float32"))
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01})
    return net, tr


def _train(net, tr, steps, seed=1):
    r = onp.random.RandomState(seed)
    for _ in range(steps):
        x = tmx.np.array(r.normal(size=(5, 4)).astype("float32"))
        with tmx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(5)


def _state(net, tr):
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    states = [[s.cpu().numpy().copy() for s in st] for st in tr._states]
    return params, states, tr.optimizer.num_update


def _same_state(a, b):
    for n in a[0]:
        onp.testing.assert_array_equal(a[0][n], b[0][n])
    for sa, sb in zip(a[1], b[1]):
        for x, y in zip(sa, sb):
            onp.testing.assert_array_equal(x, y)
    assert a[2] == b[2]


def test_training_checkpointer_resumes_bit_for_bit(tmp_path):
    prefix = str(tmp_path / "t")
    with tmx.cpu():
        net, tr = _dense_pair()
        ck = tpre.TrainingCheckpointer(prefix, net, tr, every_n=3, keep=2)
        for _ in range(4):
            _train(net, tr, 1)
            ck.step()
        tpre.trigger()                          # preempted at step 4
        saved = _state(net, tr)
        assert os.path.basename(ck._mgr.latest()) == "t-0000004.ckpt"
        _train(net, tr, 2)
        net2, tr2 = _dense_pair(seed=5)
        ck2 = tpre.TrainingCheckpointer(prefix, net2, tr2,
                                        register_signal=False)
        assert ck2.resume() == 4
        _same_state(_state(net2, tr2), saved)
        side = tpre.load_layout(prefix + "-0000004.ckpt")
        assert side == tpre._runtime_layout()


def test_training_checkpointer_falls_back_past_a_corrupt_generation(
        tmp_path):
    from incubator_mxnet_tpu_torch.telemetry import registry

    prefix = str(tmp_path / "t")
    with tmx.cpu():
        net, tr = _dense_pair()
        ck = tpre.TrainingCheckpointer(prefix, net, tr, every_n=2, keep=3,
                                       register_signal=False)
        for step in range(4):
            _train(net, tr, 1)
            ck.step()
            if step == 1:
                at_two = _state(net, tr)
        newest = ck._mgr.latest()
        with open(newest, "r+b") as f:
            f.truncate(40)
        before = registry.counter("mx_checkpoint_fallbacks_total").value
        net2, tr2 = _dense_pair(seed=5)
        ck2 = tpre.TrainingCheckpointer(prefix, net2, tr2,
                                        register_signal=False)
        assert ck2.resume() == 2
        _same_state(_state(net2, tr2), at_two)
        assert registry.counter("mx_checkpoint_fallbacks_total").value == \
            before + 1
        for p in ck2._mgr.generations():
            with open(p, "r+b") as f:
                f.truncate(10)
        with pytest.raises(MXNetError):
            ck2.resume()


def test_port_resumes_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's TrainingCheckpointer file (its npz parameters and
    its pickled Adam states) resumes the port's net and Trainer."""
    r = onp.random.RandomState(0)
    w, b = r.normal(size=(3, 4)).astype("float32"), \
        r.normal(size=3).astype("float32")
    jnet = jmx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    jnet.weight.set_data(jmx.np.array(w))
    jnet.bias.set_data(jmx.np.array(b))
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 0.01})
    x = jmx.np.array(r.normal(size=(5, 4)).astype("float32"))
    for _ in range(2):
        with jmx.autograd.record():
            loss = (jnet(x) ** 2).sum()
        loss.backward()
        jtr.step(5)
    prefix = str(tmp_path / "j")
    jck = jpre.TrainingCheckpointer(prefix, jnet, jtr, every_n=2,
                                    register_signal=False)
    jck.step(2)
    os.remove(prefix + "-0000002.ckpt.layout.json")   # another device count
    with tmx.cpu():
        net, tr = _dense_pair(seed=7)
        assert tpre.TrainingCheckpointer(prefix, net, tr,
                                         register_signal=False).resume() == 2
    onp.testing.assert_array_equal(net.weight.data().asnumpy(),
                                   jnet.weight.data().asnumpy())
    assert tr.optimizer.num_update == jtr.optimizer.num_update


def test_a_layout_from_another_device_count_is_refused(tmp_path,
                                                        monkeypatch):
    """With ``MXNET_ELASTIC=0`` a checkpoint written on another device
    count is refused with `LayoutMismatch`, as in the reference; with
    elastic resharding on (the default) it resumes through
    `fault.elastic.reshard_net` and counts the crossing."""
    from incubator_mxnet_tpu_torch.telemetry import registry

    prefix = str(tmp_path / "t")
    with tmx.cpu():
        net, tr = _dense_pair()
        ck = tpre.TrainingCheckpointer(
            prefix, net, tr, every_n=1, register_signal=False,
            layout_fn=lambda: {"format": 1, "device_count": 64,
                               "process_count": 8, "generation": 3})
        ck.step()
        monkeypatch.setenv("MXNET_ELASTIC", "0")
        with pytest.raises(tpre.LayoutMismatch, match="MXNET_ELASTIC=0"):
            ck.resume()
        monkeypatch.delenv("MXNET_ELASTIC")
        c = registry.counter("mx_elastic_layout_resumes_total")
        before = c.value
        assert ck.resume() == 1
        assert c.value == before + 1


def test_checkpoint_handler_resumes_as_the_reference(tmp_path):
    """Two fits of 4 batches with `CheckpointHandler(batch_period=2)`, the
    second resuming: the counters, the files and the parameters as the
    reference's."""
    r = onp.random.RandomState(0)
    x = r.normal(size=(8, 4)).astype("float32")
    y = r.randint(0, 3, 8).astype("int32")
    w = r.normal(size=(3, 4)).astype("float32")

    def run(mx, d):
        from importlib import import_module

        est_mod = import_module(mx.__name__ + ".gluon.contrib.estimator")
        out = []
        for _ in range(2):
            net = mx.gluon.nn.Dense(3, in_units=4)
            net.initialize()
            net.weight.set_data(mx.np.array(w))
            net.bias.set_data(mx.np.zeros(3))
            est = est_mod.Estimator(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                trainer=mx.gluon.Trainer(net.collect_params(), "sgd",
                                         {"learning_rate": 0.5}))
            h = est_mod.CheckpointHandler(d, batch_period=2,
                                          resume_from_checkpoint=True)
            est.fit(mx.gluon.data.DataLoader(
                mx.gluon.data.ArrayDataset(x, y), batch_size=2),
                batches=4, event_handlers=[h])
            out.append((h.current_batch, h.current_epoch,
                        net.weight.data().asnumpy()))
        return out, sorted(os.listdir(d))

    want = run(jmx, str(tmp_path / "ref"))
    with tmx.cpu():
        got = run(tmx, str(tmp_path / "port"))
    assert got[1] == want[1]
    for (gb, ge, gw), (wb, we, ww) in zip(got[0], want[0]):
        assert (gb, ge) == (wb, we)
        onp.testing.assert_allclose(gw, ww, rtol=0,
                                    atol=REL * float(onp.abs(ww).max()))


def _resilient_fit(mx, d, nan_batch=None, crash_after=None):
    """A Dense(3) fit over 6 batches with a `ResilienceHandler` over a
    `TrainingCheckpointer` (every 2 steps): batch ``nan_batch`` holds a
    NaN; the ``estimator_step`` seam is armed to fire once right after
    batch ``crash_after``. Returns (final weight, skips, resumes,
    checkpoint step resumed)."""
    from importlib import import_module

    est_mod = import_module(mx.__name__ + ".gluon.contrib.estimator")
    pre = import_module(mx.__name__ + ".preemption")
    res = import_module(mx.__name__ + ".fault.resilience")
    inj = import_module(mx.__name__ + ".fault.injection")
    reg = import_module(mx.__name__ + ".telemetry.registry")
    r = onp.random.RandomState(0)
    x = r.normal(size=(12, 4)).astype("float32")
    y = r.randint(0, 3, 12).astype("int32")
    if nan_batch is not None:
        x[2 * nan_batch] = onp.nan
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    net.weight.set_data(mx.np.array(r.normal(size=(3, 4)).astype("float32")))
    net.bias.set_data(mx.np.zeros(3))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5})
    est = est_mod.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            trainer=tr)
    ck = pre.TrainingCheckpointer(os.path.join(d, "ck"), net, tr, every_n=2,
                                  register_signal=False)
    guard = res.ResilienceHandler(ck)

    class Arm(est_mod.event_handler.BatchEnd):
        n = 0

        def batch_end(self, estimator, *args, **kwargs):
            Arm.n += 1
            if Arm.n == crash_after:
                inj.configure_injection("estimator_step:1.0:0:1")

    skips = reg.counter("mx_steps_skipped_nonfinite_total").value
    resumes = reg.counter("mx_resumes_total").value
    try:
        est.fit(mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(x, y),
                                         batch_size=2),
                batches=6, event_handlers=[guard, Arm()])
    finally:
        inj.clear_injection()
    return (net.weight.data().asnumpy(),
            reg.counter("mx_steps_skipped_nonfinite_total").value - skips,
            reg.counter("mx_resumes_total").value - resumes, ck._mgr._step)


@pytest.mark.parametrize("case", ["nonfinite", "crash"])
def test_resilience_equals_reference(case, tmp_path):
    kw = dict(nan_batch=2) if case == "nonfinite" else dict(crash_after=3)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _resilient_fit(jmx, str(tmp_path / "ref"), **kw)
    with tmx.cpu():
        got = _resilient_fit(tmx, str(tmp_path / "port"), **kw)
    onp.testing.assert_allclose(got[0], want[0], rtol=0,
                                atol=REL * float(onp.abs(want[0]).max()))
    assert got[1:] == want[1:]
    assert got[1 if case == "nonfinite" else 2] == 1


def test_resilience_backs_the_amp_scale_off_and_refuses_elastic():
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.fault.resilience import ResilienceHandler

    class Est:
        logger = __import__("logging").getLogger("t")

    amp.init("float16")
    try:
        amp.scale_loss._scaler = amp.LossScaler()
        before = amp.scale_loss._scaler.loss_scale
        ResilienceHandler._amp_backoff(Est())
        assert amp.scale_loss._scaler.loss_scale == before / 2
    finally:
        amp.deinit()
        amp.scale_loss._scaler = None
    # the elastic controller is ported: the handler takes one and polls it
    # at every batch end; a "leave" verdict ends the fit

    class Ctl:
        verdicts = ["stable", "leave"]

        def poll(self):
            return self.verdicts.pop(0)

    class Fit(Est):
        stop_training = False

    h = ResilienceHandler(elastic=Ctl())
    est = Fit()
    h.batch_end(est)
    assert not est.stop_training
    h.batch_end(est)
    assert est.stop_training
