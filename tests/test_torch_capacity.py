"""The port's per-tenant cost ledger (`incubator_mxnet_tpu_torch.
telemetry.capacity`) against the JAX package's, on the CPU: the capacity
tests of `tests/test_capacity_observatory.py` (:413-511) as cases of both
packages — per-tenant tokens, prefill and decode device-seconds and KV
page-seconds through a stub gateway, the wall audit (per-tenant
device-seconds sum back to the measured wall within 5%), the queue-wait
view observed once despite a preemption, the disarmed dead branch — and
the same charges rolling up to the same `ledger_report` in both.
"""
import time
from types import SimpleNamespace

import numpy as onp
import pytest

from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.telemetry import capacity as jcapacity
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.telemetry import capacity as tcapacity
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry

VOCAB = 97

PKGS = {
    "ref": SimpleNamespace(serve=jserve, capacity=jcapacity,
                           registry=jregistry),
    "port": SimpleNamespace(serve=tserve, capacity=tcapacity,
                            registry=tregistry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.capacity.disable()
    p.capacity.reset()
    yield p
    p.capacity.disable()
    p.capacity.reset()


class _StubSlots:
    """The paged interface in host arithmetic (`tests/
    test_capacity_observatory.py:367`) over a package's allocator."""

    def __init__(self, pkg, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
        pages_per_slot = -(-max_len // page_tokens)
        self.allocator = pkg.serve.PageAllocator(
            max_slots * pages_per_slot + 1, page_tokens)
        self.prefix_cache = pkg.serve.PrefixCache(self.allocator)

    def set_slot_pages(self, slot, pages):
        pass

    def clear_slot(self, slot):
        pass

    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        n = len(chunk_tokens)
        return int(t_start) + n, n, 0

    def decode_step(self, last_tok, pos, active, key, temperature):
        return onp.where(active, last_tok + 1, last_tok).astype(onp.int32)

    def xla_program_count(self):
        return 0

    def release(self):
        pass


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def _stub_gateway(pkg, model="m", max_slots=2, **gw_kwargs):
    reg = pkg.serve.ModelRegistry()
    reg.add(model, _StubSlots(pkg, max_slots=max_slots))
    return pkg.serve.Gateway(reg, **gw_kwargs)


def test_ledger_attributes_per_tenant_and_audits_wall(pkg):
    cap = pkg.capacity
    cap.enable()
    gw = _stub_gateway(pkg, model="cm")
    handles = [gw.submit("cm", _prompt(8, seed=i), 6, tenant=tenant)
               for i, tenant in enumerate(["acme", "beta", "acme", "beta",
                                           "crawl"])]
    gw._drive_until(handles, timeout=30)
    led = cap.ledger_report()
    for tenant in ("acme", "beta", "crawl"):
        row = led["tenants"][tenant]["cm"]
        assert row["tokens"] > 0, (tenant, led)
        assert row["kv_page_s"] > 0, (tenant, led)
        assert row["device_s"]["prefill"] > 0, (tenant, led)
        assert row["device_s"]["decode"] > 0, (tenant, led)
    # the wall audit over this test's model (the registry is the
    # process's, so other tests' rows may sit beside it)
    wall = led["measured_wall_s"]
    device_s = sum(s for t in led["tenants"].values()
                   for s in t.get("cm", {}).get("device_s", {}).values())
    assert wall > 0
    assert abs(device_s - wall) <= 0.05 * wall, led
    tokens = sum(len(h.tokens) for h in handles)
    assert tokens == 30
    assert sum(led["tenants"][t]["cm"]["tokens"]
               for t in ("acme", "beta", "crawl")) >= tokens


def test_queue_wait_observed_once_despite_preemption(pkg):
    pkg.capacity.enable()
    gw = _stub_gateway(pkg, model="qm", max_slots=1, tiers="high,low")
    h0 = pkg.registry.histogram("mx_serve_queue_wait_seconds",
                                labels={"tenant": "torch_bulk"})
    n0 = h0.snapshot()["count"]
    low = gw.submit("qm", _prompt(24, seed=1), 12, tenant="torch_bulk",
                    priority="low")
    deadline = time.monotonic() + 10
    while low.state != "dispatched":
        gw.step()
        assert time.monotonic() < deadline
    high = gw.submit("qm", _prompt(8, seed=2), 4, tenant="torch_vip",
                     priority="high")
    gw._drive_until([low, high], timeout=30)
    assert low.preemptions >= 1
    assert h0.snapshot()["count"] == n0 + 1
    led = pkg.capacity.ledger_report()
    assert led["tenants"]["torch_bulk"]["qm"]["queue_wait_s"] >= 0


def test_charges_are_dead_branch_when_disarmed(pkg):
    cap = pkg.capacity
    assert not cap.is_enabled()
    cap.charge_tokens("t_off", "m")
    cap.charge_device_seconds("t_off", "m", "decode", 1.0)
    cap.split_device_seconds(["t_off"], "m", "prefill", 1.0)
    cap.charge_kv_page_seconds("t_off", "m", 1.0)
    cap.charge_queue_wait("t_off", "m", 1.0)
    assert cap.measured_wall_s() == 0.0
    assert "t_off" not in cap.ledger_report()["tenants"]
    assert not [k for k in pkg.registry.report()
                if k.startswith("mx_capacity_") and 't_off' in k]


def test_same_charges_same_ledger_in_both():
    """One sequence of charges (tokens, a split batched window, page-
    seconds, queue waits, an anonymous tenant) rolls up to the same
    `ledger_report` rows in both packages."""
    outs = []
    for p in (PKGS["port"], PKGS["ref"]):
        p.capacity.reset()
        p.capacity.enable()
        try:
            p.capacity.charge_tokens("x_acme", "x_m", 5)
            p.capacity.split_device_seconds(["x_acme", "x_acme", "x_beta",
                                             None], "x_m", "decode", 2.0)
            p.capacity.split_device_seconds(["x_beta"], "x_m", "prefill",
                                            0.5)
            p.capacity.charge_kv_page_seconds("x_beta", "x_m", 3.25)
            p.capacity.charge_queue_wait("x_acme", "x_m", 0.125)
            led = p.capacity.ledger_report()
            rows = {t: led["tenants"][t]["x_m"]
                    for t in ("x_acme", "x_beta")}
            rows["anon_decode"] = led["tenants"]["anon"]["x_m"][
                "device_s"].get("decode")
            outs.append((rows, p.capacity.measured_wall_s()))
        finally:
            p.capacity.disable()
            p.capacity.reset()
    assert outs[0] == outs[1]
    assert outs[0][1] == pytest.approx(2.5)
    view = tcapacity.capacity_view({
        'mx_capacity_tokens_total{model="a",tenant="t"}': {"value": 3},
        'mx_other_total{x="1"}': {"value": 9}})
    assert view == {"t": {"a": {"tokens": 3, "device_s": {},
                                "kv_page_s": 0.0, "queue_wait_s": 0.0}}}
