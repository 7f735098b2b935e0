"""Sharded serving: a `SlotDecoder` replica whose weights and KV pools are
cut over a mesh of ranks (port of `incubator_mxnet_tpu/serve/sharded.py`:
`parse_mesh_spec` :69, `serve_mesh` :95, `ServeLayout` :131,
`ShardedSlotDecoder` :294).

The layout is the reference's (`ServeLayout`, its rule table verbatim):

- the K/V pools ``(n_pages, H, page_tokens, d)`` are cut on the head axis,
  so each rank holds its heads' pages of the whole pool (1/tp of it), and
  the int8 scale planes ``(n_pages, H)`` the same way;
- the fused qkv product runs **row-parallel**: it cuts the input features,
  and one all-reduce leaves q, k and v whole on every rank; each rank then
  takes its own heads' q/k/v and writes its heads' K/V into its pools, so
  no head exchange is needed. proj is row-parallel over the head-cut
  attention context, ffn1 column-parallel (its bias cut with it) and ffn2
  row-parallel: three all-reduces a layer, each of an (S, T, C) partial,
  each bias added once after the sum;
- the embeddings, the positional table and the norms are replicated,
  explicitly (every leaf must match a rule: an unmatched one raises).

**One front, its shards.** The reference drives every device of a
replica's mesh from one process. The port runs one process per rank, so
the host side (`Scheduler`, `Gateway`, router, prefix cache, page
allocator, telemetry) runs once, in the world's rank 0, the *front*: a
`ShardedSlotDecoder` there keeps the reference's host API, and each of
its device calls (a prefill chunk, the decode step, verify, a page copy
out or in, a weight refresh, the pre-flight, a release) is one small
**record** — the op, its host inputs and the page table when it changed
— broadcast over the world's gloo control group. Every other rank runs
`_serve_shards`, a loop that executes the records of the engines whose
mesh it is on (its :class:`_Shard`: the rank's blocks and pools, and the
base engine's step bodies with the products cut through the seams), until
`_stop_shards`; the mesh's first rank sends the result back to the front.
A front on the mesh computes its own share in place. The weights are the
front's model's: each rank's blocks are cut from its tensors by the
layout and sent at placement, and again whenever the model's weights
change (a tensor replaced, or written in place: `hot_swap`), copied into
the blocks in place. The shards never hold the model's own parameters, so
the replicas, the hot swap and an unsharded engine beside them share one
model.

On a mesh of one rank nothing is exchanged and every step is the base
engine's, a replayed CUDA graph on the card, bit for bit the unsharded
engine's. Over a gloo group (tp > 1) the steps run eagerly (a gloo
collective cannot be captured) and their CUDA tensors go through host
memory (`parallel.collectives.transport`); a build is then counted as a
CPU model's is (`SlotDecoder.xla_program_count`). A mesh's ``fsdp`` axis
must be of size 1 (the reference rides it on the complementary dims; the
port serves tensor parallelism only), and a sharded engine drafts with
the n-gram proposer (a draft model is not cut).
"""
from __future__ import annotations

import itertools
import logging
import os
import pickle
import re

import numpy as onp
import torch
import torch.nn.functional as F

from ..models.decoding import GPTDecoder, _gelu, _t
from ..parallel import collectives as _coll
from ..parallel._layout import bounds, clean_spec
from ..parallel.mesh import Mesh, _world, make_mesh
from .engine import _LAYER_LEAVES, SlotDecoder

__all__ = ["ServeLayout", "ShardedSlotDecoder", "parse_mesh_spec",
           "serve_mesh"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.serve")

#: The world's rank that runs the host side of every sharded engine.
_FRONT = 0


def parse_mesh_spec(spec):
    """Parse a mesh spec into ``{"axis": size}``.

    Accepts a dict (returned as-is), an int / numeric string ``"4"``
    (tensor-parallel degree), or ``"tp=4"`` / ``"fsdp=2,tp=4"`` — the
    grammar of the ``MXNET_SERVE_MESH`` env knob."""
    if isinstance(spec, dict):
        return dict(spec)
    if isinstance(spec, int):
        return {"tp": int(spec)}
    s = str(spec).strip()
    if not s:
        return {"tp": 1}
    if s.isdigit():
        return {"tp": int(s)}
    axes = {}
    for part in s.split(","):
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'axis=size[,..]' "
                f"(e.g. 'tp=4' or 'fsdp=2,tp=4')")
        k, v = part.split("=", 1)
        axes[k.strip()] = int(v)
    return axes


def serve_mesh(spec=None, devices=None):
    """A serving mesh from ``spec`` (default: the ``MXNET_SERVE_MESH`` env
    knob, else ``tp=1``) over the FIRST ``prod(sizes)`` of ``devices`` — the
    world's ranks by default, as the reference takes its first devices: a
    replica's mesh is a slice of the world, not the world."""
    if spec is None:
        spec = os.environ.get("MXNET_SERVE_MESH", "") or {"tp": 1}
    axes = parse_mesh_spec(spec)
    need = 1
    for v in axes.values():
        need *= int(v)
    if devices is None:
        devices = range(_world()[2])
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(
            f"serve_mesh: spec {axes} needs {need} devices, have "
            f"{len(devices)}")
    return make_mesh(axes, devices=devices[:need])


def _spec_str(spec):
    """The reference's text of a spec (``str(PartitionSpec(...))``)."""
    return f"PartitionSpec{tuple(spec)!r}"


class ServeLayout:
    """Partition rules mapping every serving param/pool leaf to a spec on
    ``mesh`` (a `parallel.Mesh`).

    ``rules`` is an ordered ``(regex, spec)`` sequence matched (first hit
    wins, `re.search`) against the leaf's path, the reference decoder's
    (``layers/qkv_w``, ``embed``, ...; `engine._param_tree`). A spec is the
    port's: a tuple with one entry per dimension, ``()`` replicated on
    purpose. A leaf no rule matches raises `ValueError`: silent
    replication of an unplaced leaf is what shardcheck SC001 exists to
    catch, so the layout refuses to make it. The ``layers/*`` specs carry
    the reference's leading layer axis; the port's weights are per layer,
    so `param_specs` drops it."""

    def __init__(self, mesh, rules=None, tp_axis="tp", fsdp_axis="fsdp"):
        self.mesh = mesh
        self.tp_axis = tp_axis
        axes = set(dict(mesh.shape))
        if tp_axis not in axes:
            raise ValueError(
                f"ServeLayout: mesh axes {sorted(axes)} lack "
                f"{tp_axis!r} (build the mesh with serve_mesh)")
        # pure-tp serving meshes (the replica_meshes default) simply
        # leave the fsdp dim unsharded
        self.fsdp_axis = fsdp_axis if fsdp_axis in axes else None
        self.rules = tuple(rules) if rules is not None \
            else self._default_rules()
        self._compiled = tuple((re.compile(rx), spec)
                               for rx, spec in self.rules)

    # -- rule table ---------------------------------------------------------

    def _default_rules(self):
        tp, fs = self.tp_axis, self.fsdp_axis
        # Weights are (out, in) and applied as ``y = x @ w.T``, so
        # "row-parallel" = tp on the LAST dim (input features) and
        # "column-parallel" = tp on the middle dim (output features); the
        # first entry is the reference's stacked layer axis.
        return (
            # attention: the fused qkv output axis is [q|k|v]-contiguous
            # and a contiguous tp cut of 3C can never align with heads,
            # so qkv runs ROW-parallel (contract over tp-cut input
            # features, one all-reduce, replicated q/k/v) and its bias
            # stays replicated with the output. proj is row-parallel too:
            # its input is the head-cut attention context.
            (r"layers/qkv_w$", (None, fs, tp)),
            (r"layers/qkv_b$", (None,)),
            (r"layers/proj_w$", (None, fs, tp)),
            (r"layers/proj_b$", (None,)),
            # MLP: the Megatron pair — ffn1 column-parallel (output
            # features on tp, bias cut along), gelu local, ffn2
            # row-parallel (all-reduce back to replicated)
            (r"layers/ffn1_w$", (None, tp, fs)),
            (r"layers/ffn1_b$", (None, tp)),
            (r"layers/ffn2_w$", (None, fs, tp)),
            (r"layers/ffn2_b$", (None,)),
            # small per-layer norm vectors: replicated, explicitly
            (r"layers/ln[0-9]+_[gb]$", (None,)),
            # embeddings / positional / final norm / untied head:
            # replicated (page tables ride along as host arrays)
            (r"^embed$", ()),
            (r"^pos$", ()),
            (r"^lnf_[gb]$", ()),
            (r"^head_w$", ()),
        )

    def pool_spec(self):
        """K/V pool leaves ``(n_pages, H, page_tokens, d)``: heads on the
        TP axis."""
        return (None, self.tp_axis, None, None)

    def scale_spec(self):
        """int8 per-page scale planes ``(n_pages, H)``: same H axis."""
        return (None, self.tp_axis)

    # -- matching -----------------------------------------------------------

    def spec_for(self, path):
        for rx, spec in self._compiled:
            if rx.search(path):
                return spec
        raise ValueError(
            f"ServeLayout: no partition rule matches param leaf "
            f"{path!r} — add an explicit rule (silent replicated "
            f"fallback is not allowed; see SERVING.md pod-scale notes)")

    def leaf_spec(self, path):
        """The spec of one of the port's tensors at ``path``: a
        ``layers/*`` leaf's without the stacked layer axis."""
        spec = self.spec_for(path)
        return tuple(spec)[1:] if path.startswith("layers/") else spec

    def param_specs(self, params):
        """Spec tree mirroring ``params`` (`engine._param_tree`: per-layer
        lists under ``"layers"``); raises on any unmatched leaf."""
        out = {}
        for key, val in params.items():
            if key == "layers":
                out[key] = {name: [self.leaf_spec(f"layers/{name}")] *
                            len(leaves) for name, leaves in val.items()}
            else:
                out[key] = self.leaf_spec(key)
        return out

    def sharding(self, spec):
        """``spec`` with its trailing None entries stripped: the form the
        reference places with (its `NamedSharding`'s spec), the same
        spec as far as the cut goes."""
        entries = tuple(spec)
        while entries and entries[-1] is None:
            entries = entries[:-1]
        return entries

    # -- placement ----------------------------------------------------------

    def _mine(self, t, spec):
        """This rank's block of the whole tensor ``t`` under ``spec``."""
        return _cut(t, spec, self.mesh, _coords(self.mesh, _world()[1]))

    def place_params(self, params):
        """This rank's blocks (views) of every leaf of ``params``
        (`engine._param_tree`'s tree), per its matched rule."""
        specs = self.param_specs(params)
        return {key: ({name: [self._mine(t, specs[key][name][0])
                              for t in leaves]
                       for name, leaves in val.items()} if key == "layers"
                      else self._mine(val, specs[key]))
                for key, val in params.items()}

    def place_pools(self, pk, pv, sk, sv):
        """This rank's heads (views) of the per-layer pool leaves and of
        the int8 scale planes."""
        ps, ss = self.pool_spec(), self.scale_spec()
        pk = tuple(self._mine(x, ps) for x in pk)
        pv = tuple(self._mine(x, ps) for x in pv)
        if sk is not None:
            sk = tuple(self._mine(x, ss) for x in sk)
            sv = tuple(self._mine(x, ss) for x in sv)
        return pk, pv, sk, sv

    def constrain_pools(self, pk, pv, sk, sv):
        """The reference pins a traced program's updated pools to their
        input placement; the port's pools are written in place, so this is
        the identity."""
        return pk, pv, sk, sv

    def describe(self):
        """Human-readable rule table (docs/tests)."""
        return [(rx, _spec_str(spec)) for rx, spec in self.rules]


def _leaf_paths(params):
    """The leaf paths of `engine._param_tree`'s tree, one a tensor
    (``layers/qkv_w`` once a layer)."""
    out = []
    for key, val in params.items():
        if key == "layers":
            out.extend(f"layers/{name}" for name, leaves in val.items()
                       for _ in leaves)
        else:
            out.append(key)
    return out


# ---------------------------------------------------------------------------
# cutting the model into each rank's blocks
# ---------------------------------------------------------------------------

def _leaf_order(model):
    """(path, layer or None, tensor) of every weight the steps read, in
    the order blocks are shipped."""
    out = [(f"layers/{name}", i, _t(get(b)))
           for name, get in _LAYER_LEAVES
           for i, b in enumerate(model.blocks)]
    out += [("embed", None, _t(model.word_embed.weight)),
            ("pos", None, _t(model.position_embed)),
            ("lnf_g", None, _t(model.ln_f.gamma)),
            ("lnf_b", None, _t(model.ln_f.beta))]
    if not model._tie:
        out.append(("head_w", None, _t(model.lm_head.weight)))
    return out


def _coords(mesh, rank):
    hit = onp.argwhere(mesh.devices == rank)[0]
    return dict(zip(mesh.axis_names, (int(i) for i in hit)))


def _cut(t, spec, mesh, coords):
    """The block of the whole tensor ``t`` that the rank at ``coords``
    holds under ``spec`` (a view; `_layout.bounds`'s blocks)."""
    for d, axes in enumerate(clean_spec(spec, t.dim(), mesh)):
        idx, n = 0, 1
        for a in axes:
            idx = idx * mesh.axis_size(a) + coords[a]
            n *= mesh.axis_size(a)
        if n > 1:
            start, stop = bounds(t.shape[d], idx, n)
            t = t.narrow(d, start, stop - start)
    return t


class _Held:
    """A tensor where a decoder reads a gluon Parameter (`decoding._t`
    reads ``p.data()._data``)."""

    __slots__ = ("_data",)

    def __init__(self, t):
        self._data = t

    def data(self):
        return self

    @property
    def shape(self):
        return tuple(self._data.shape)


class _Node:
    """An attribute bag standing for a module of the model."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _shadow(cfg, held, device):
    """A model of `_Node`\\ s over the rank's blocks (``held``: path ->
    [one `_Held` a layer] or a `_Held`) with the attributes the decoder
    and the engine read."""
    H, C = cfg["n_heads"], cfg["units"]

    def lin(w, b, i):
        return _Node(weight=held[w][i], bias=held[b][i])

    def norm(g, b, eps):
        return _Node(gamma=g, beta=b, _epsilon=eps)

    blocks = []
    for i, (e1, e2) in enumerate(cfg["eps"]):
        blocks.append(_Node(
            ln1=norm(held["layers/ln1_g"][i], held["layers/ln1_b"][i], e1),
            attn=_Node(_num_heads=H, _units=C,
                       qkv=lin("layers/qkv_w", "layers/qkv_b", i),
                       proj=lin("layers/proj_w", "layers/proj_b", i)),
            ln2=norm(held["layers/ln2_g"][i], held["layers/ln2_b"][i], e2),
            ffn=_Node(ffn1=lin("layers/ffn1_w", "layers/ffn1_b", i),
                      ffn2=lin("layers/ffn2_w", "layers/ffn2_b", i))))
    return _Node(
        blocks=blocks, word_embed=_Node(weight=held["embed"]),
        position_embed=held["pos"],
        ln_f=norm(held["lnf_g"], held["lnf_b"], cfg["eps_f"]),
        _tie=cfg["tie"],
        lm_head=None if cfg["tie"] else _Node(weight=held["head_w"]),
        max_length=cfg["max_length"], device=device)


# ---------------------------------------------------------------------------
# the control plane: records from the front, replies from a mesh's lead
# ---------------------------------------------------------------------------

_CTL = {"group": None}
_SLOT = 8192            # a record's fixed first message (its length first)
_ENGINE_IDS = itertools.count(1)


def _ctl():
    """The world's control group: the gloo world itself, or a gloo group
    over every rank of an NCCL world (made by every rank in turn: the
    front at its first engine with remote ranks, the others in
    `_serve_shards`)."""
    import torch.distributed as tdist

    if _CTL["group"] is None:
        _CTL["group"] = (tdist.group.WORLD
                         if str(tdist.get_backend()) == "gloo"
                         else tdist.new_group(backend="gloo"))
    return _CTL["group"]


def _frame(obj):
    """``obj`` pickled into a ``_SLOT``-byte frame (length first) and the
    rest of the payload, if any, as a second tensor."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    n = len(payload)
    head = torch.zeros(_SLOT, dtype=torch.uint8)
    head[:8] = torch.tensor([n], dtype=torch.int64).view(torch.uint8)
    k = min(n, _SLOT - 8)
    head[8:8 + k] = torch.frombuffer(bytearray(payload[:k]),
                                     dtype=torch.uint8)
    rest = (torch.frombuffer(bytearray(payload[k:]), dtype=torch.uint8)
            if n > k else None)
    return head, rest


def _unframe(head, recv_rest):
    n = int(head[:8].view(torch.int64)[0])
    k = min(n, _SLOT - 8)
    payload = bytes(head[8:8 + k].numpy())
    if n > k:
        rest = torch.empty(n - k, dtype=torch.uint8)
        recv_rest(rest)
        payload += bytes(rest.numpy())
    return pickle.loads(payload)


def _post(record):
    """Broadcast ``record`` from the front to every rank."""
    import torch.distributed as tdist

    g = _ctl()
    head, rest = _frame(record)
    tdist.broadcast(head, src=_FRONT, group=g)
    if rest is not None:
        tdist.broadcast(rest, src=_FRONT, group=g)


def _recv_record():
    import torch.distributed as tdist

    g = _ctl()
    head = torch.empty(_SLOT, dtype=torch.uint8)
    tdist.broadcast(head, src=_FRONT, group=g)
    return _unframe(head, lambda t: tdist.broadcast(t, src=_FRONT, group=g))


def _reply(obj):
    """A mesh's lead sends a result to the front."""
    import torch.distributed as tdist

    g = _ctl()
    head, rest = _frame(obj)
    tdist.send(head, dst=_FRONT, group=g)
    if rest is not None:
        tdist.send(rest, dst=_FRONT, group=g)


def _recv_reply(lead):
    import torch.distributed as tdist

    g = _ctl()
    head = torch.empty(_SLOT, dtype=torch.uint8)
    tdist.recv(head, src=lead, group=g)
    return _unframe(head, lambda t: tdist.recv(t, src=lead, group=g))


def _to_host(obj):
    """A result with its tensors on the host (to pickle it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _serve_shards():
    """The loop of every rank but the front: executes the records of the
    engines whose mesh this rank is on, until the front's `_stop_shards`.
    Records of other engines are read and passed over."""
    up, me, _ = _world()
    if not up or me == _FRONT:
        raise ValueError("_serve_shards runs on the ranks of a world "
                         f"other than the front (rank {_FRONT})")
    shards = {}
    while True:
        eid, op, args, table, name = _recv_record()
        if op == "stop":
            return
        if op == "new":
            if me in args["ranks"]:
                shards[eid] = _Shard.join(args)
            continue
        shard = shards.get(eid)
        if shard is None:
            continue
        if op == "place":
            shard._place(shard._recv_blocks())
            continue
        out = shard._execute(op, args, table, name)
        if op == "close":
            del shards[eid]
            continue
        if me == shard._lead:
            _reply(_to_host(out))


def _stop_shards():
    """End every rank's `_serve_shards` loop (the front, once the world
    serves no more)."""
    up, me, n = _world()
    if up and n > 1 and me == _FRONT:
        _post((0, "stop", None, None, None))


# ---------------------------------------------------------------------------
# a rank's share of an engine
# ---------------------------------------------------------------------------

class _Shard(SlotDecoder):
    """One rank's share of a sharded engine: its blocks (a model of
    `_Held`\\ s, `_shadow`), its pools (its heads), and the base engine's
    step bodies, whose three products (`_qkv`, `_proj`, `_ffn`) are cut
    here: partial products, their all-reduce over the mesh's tp group,
    each bias once after the sum. The page table comes with the front's
    records; the page allocator and prefix cache are the front's."""

    _PUBLISHES = False

    def __init__(self, cfg, mesh, group, blocks, device):
        self._cfg = cfg
        self.layout = ServeLayout(mesh, rules=cfg["rules"],
                                  tp_axis=cfg["tp_axis"],
                                  fsdp_axis=cfg["fsdp_axis"])
        tp_axis = self.layout.tp_axis
        self._tp = mesh.axis_size(tp_axis)
        # a tp axis of one rank exchanges nothing, whatever the world
        self._group = group if self._tp > 1 else None
        self._lead = cfg["ranks"][0]
        c = _coords(mesh, cfg["rank"])[tp_axis]
        C, H = cfg["units"], cfg["n_heads"]
        self._cols = bounds(C, c, self._tp)                # my features
        self._heads = bounds(H, c, self._tp)               # my heads
        self._whole = cfg["whole"]                         # path -> shape
        self._held = {}
        for (path, layer), t in zip(cfg["order"], blocks):
            h = _Held(t)
            if layer is None:
                self._held[path] = h
            else:
                self._held.setdefault(path, []).append(h)
        self._version = 0
        model = _shadow(cfg, self._held, device)
        super().__init__(GPTDecoder(model, impl=cfg["impl"]),
                         **cfg["engine"])

    @classmethod
    def join(cls, cfg):
        """A remote rank's shard of a new engine: its tp group (made with
        the mesh's other ranks), then its blocks from the front."""
        mesh = Mesh(onp.asarray(cfg["devices"]), cfg["axis_names"])
        cfg = dict(cfg, rank=_world()[1])
        group = (mesh.group(cfg["tp_axis"])
                 if mesh.axis_size(cfg["tp_axis"]) > 1 else None)
        dev = torch.device(cfg["device_type"])
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return cls(cfg, mesh, group, _recv_flat(cfg, dev), dev)

    def _recv_blocks(self):
        return _recv_flat(self._cfg, self._device)

    def _place(self, blocks):
        """New values of the rank's blocks, copied in place: the steps
        (and a mesh of one's graphs) read them by address."""
        for h, t in zip(self._held_order(), blocks):
            h._data.copy_(t)
        self._version += 1

    def _held_order(self):
        counters = {}
        out = []
        for path, layer in self._cfg["order"]:
            h = self._held[path]
            if layer is None:
                out.append(h)
            else:
                i = counters.get(path, 0)
                counters[path] = i + 1
                out.append(h[i])
        return out

    # -- the seams ----------------------------------------------------------

    def _fingerprint(self):
        return (self._version,)

    def _captures_steps(self):
        # a gloo collective cannot be captured: tp > 1 runs eagerly
        return self._group is None and super()._captures_steps()

    def _param_arrays(self):
        return [h._data for h in self._held_order()]

    def _pool_heads(self, dec):
        return dec._n_heads // self._tp

    def _sum(self, t):
        """The all-reduce of a partial product over the tp group."""
        _coll._census("all_reduce", self.layout.tp_axis, t)
        return _coll._raw_all_reduce(t, self._group)

    def _qkv(self, dec, x, blk):
        if self._group is None:
            return super()._qkv(dec, x, blk)
        N, T, C = x.shape
        a = blk.attn
        lo, hi = self._cols
        h = dec._ln(x, blk.ln1)[..., lo:hi]
        qkv = self._sum(F.linear(h, _t(a.qkv.weight))) + _t(a.qkv.bias)
        H = dec._n_heads
        q, k, v = qkv.view(N, T, 3, H, C // H).unbind(2)
        h0, h1 = self._heads
        return q[:, :, h0:h1], k[:, :, h0:h1], v[:, :, h0:h1]

    def _proj(self, dec, o, blk):
        if self._group is None:
            return super()._proj(dec, o, blk)
        a = blk.attn
        return self._sum(F.linear(o, _t(a.proj.weight))) + _t(a.proj.bias)

    def _ffn(self, dec, x, blk):
        if self._group is None:
            return super()._ffn(dec, x, blk)
        f = blk.ffn
        h = _gelu(F.linear(dec._ln(x, blk.ln2), _t(f.ffn1.weight),
                           _t(f.ffn1.bias)))
        return x + (self._sum(F.linear(h, _t(f.ffn2.weight)))
                    + _t(f.ffn2.bias))

    # -- page migration by heads --------------------------------------------

    def _gather_pages(self, idx):
        """Whole pages: this rank's heads gathered with the mesh's."""
        out = super()._gather_pages(idx)
        if self._group is None:
            return out
        return {name: [_coll._raw_all_gather(t, self._group, 1)
                       for t in planes] for name, planes in out.items()}

    def _scatter_pages(self, idx, payload):
        h0, h1 = self._heads
        super()._scatter_pages(idx, {name: [t[:, h0:h1] for t in planes]
                                     for name, planes in payload.items()})

    def slot_kv(self, slot, n_tokens):
        k, v = super().slot_kv(slot, n_tokens)
        if self._group is None:
            return k, v
        return tuple(_coll._raw_all_gather(torch.from_numpy(a), self._group,
                                           1).numpy() for a in (k, v))

    # -- the pre-flight over the layout -------------------------------------

    def _shardcheck_params(self):
        from ..analysis.shardcheck import ShapeDtype

        def leaf(path, h):
            return ShapeDtype(self._whole[path], h._data.dtype, block=h._data)

        return {key: ({name: [leaf(f"layers/{name}", h)
                              for h in self._held[f"layers/{name}"]]
                       for name, _g in _LAYER_LEAVES} if key == "layers"
                      else leaf(key, self._held[key]))
                for key in ["layers"] + [p for p in self._held
                                         if not p.startswith("layers/")]}

    def _shardcheck_pools(self):
        from ..analysis.shardcheck import ShapeDtype

        H = self._dec._n_heads

        def whole(t):
            shape = (t.shape[0], H) + tuple(t.shape[2:])
            return ShapeDtype(shape, t.dtype, block=t)

        return tuple(tuple(whole(t) for t in planes)
                     for planes in super()._shardcheck_pools())

    def _shardcheck_specs(self):
        ps, ss = self.layout.pool_spec(), self.layout.scale_spec()
        return (self.layout.param_specs(self._shardcheck_params()), ps,
                ps) + ((ss, ss) if self._int8 else ())

    def _shardcheck_out_specs(self):
        # the steps return the tokens alone, whole on every rank (the
        # pools are written in place)
        return ()

    def shardcheck_report(self, mesh=None, hbm_budget_gb=None, bucket=None):
        return super().shardcheck_report(
            mesh=self.layout.mesh if mesh is None else mesh,
            hbm_budget_gb=hbm_budget_gb, bucket=bucket)

    def hbm_crosscheck(self, mesh=None):
        return super().hbm_crosscheck(
            mesh=self.layout.mesh if mesh is None else mesh)

    # -- executing a record -------------------------------------------------

    _OPS = frozenset(("prefill_chunk_step", "decode_step", "spec_verify_step",
                      "copy_pages_out", "copy_pages_in", "release",
                      "slot_kv", "shardcheck_report", "hbm_crosscheck",
                      "close"))

    def _execute(self, op, args, table, name):
        """Run one record's op on this rank; returns ``(status, value,
        programs)`` (the value, or the exception it raised)."""
        self.census_name = name
        if table is not None:
            self._table[:] = table
            self._table_dirty = True
        try:
            if op not in self._OPS:
                raise ValueError(f"unknown sharded op {op!r}")
            value = self.release() if op == "close" \
                else getattr(self, op)(*args)
            status = "ok"
        except Exception as e:  # the front re-raises the lead's
            _LOG.warning("sharded serving: %s failed on rank %d: %s", op,
                         _world()[1], e)
            try:
                pickle.dumps(e)
            except Exception:
                e = RuntimeError(f"{type(e).__name__}: {e}")
            status, value = "error", e
        return status, value, self.xla_program_count()


def _recv_flat(cfg, device):
    """The blocks the front sends this rank, in ``cfg["order"]``."""
    import torch.distributed as tdist

    shapes = cfg["blocks_of"][cfg["rank"]]
    dtype = cfg["dtype"]
    flat = torch.empty(sum(int(onp.prod(s)) for s in shapes), dtype=dtype)
    tdist.recv(flat, src=_FRONT, group=_ctl())
    out, at = [], 0
    for s in shapes:
        n = int(onp.prod(s))
        out.append(flat[at:at + n].view(s).to(device).clone())
        at += n
    return out


# ---------------------------------------------------------------------------
# the front
# ---------------------------------------------------------------------------

class ShardedSlotDecoder(SlotDecoder):
    """A `SlotDecoder` whose weights and KV pools are cut over a mesh of
    ranks.

    Same constructor as the base engine plus ``mesh=`` (a `parallel.Mesh`,
    a mesh spec for :func:`serve_mesh`, or None to read
    ``MXNET_SERVE_MESH``), ``layout=`` (a prebuilt :class:`ServeLayout`;
    overrides ``mesh``) and ``hbm_budget_gb`` (SC006's budget in
    `shardcheck_report`). It is made on the world's rank 0, the front,
    which keeps the host state (page allocator, prefix cache, page table)
    and sends each device call to the mesh's ranks, which run
    `_serve_shards`; the engine's host API (scheduler, gateway, prefix
    cache) is unchanged."""

    def __init__(self, source, mesh=None, layout=None, hbm_budget_gb=None,
                 **engine_kwargs):
        if layout is None:
            if not isinstance(mesh, Mesh):
                mesh = serve_mesh(mesh)
            layout = ServeLayout(mesh)
        self.layout = layout
        self.hbm_budget_gb = hbm_budget_gb
        self._placed_ids = None
        self._id = None
        self._local = None
        self._programs = self._programs_closed = 0
        self._pools_live = False
        super().__init__(source, **engine_kwargs)
        if self._draft_dec is not None:
            raise ValueError(
                "ShardedSlotDecoder: a draft model is not cut over the "
                "mesh; draft with the n-gram proposer (draft='ngram')")
        self._check_divisibility()
        mesh = layout.mesh
        fs = layout.fsdp_axis
        if fs is not None and mesh.axis_size(fs) > 1:
            raise ValueError(
                f"ShardedSlotDecoder: the port serves tensor parallelism "
                f"only; the mesh's {fs!r} axis must be of size 1, got "
                f"{mesh.axis_size(fs)}")
        up, me, n = _world()
        self._ranks = [int(r) for r in mesh.devices.ravel()]
        if me != _FRONT:
            raise ValueError(
                f"ShardedSlotDecoder is made on the front (rank {_FRONT}); "
                f"rank {me} runs serve.sharded._serve_shards()")
        if any(r >= n for r in self._ranks):
            raise ValueError(f"mesh ranks {self._ranks} exceed the world "
                             f"of {n}")
        self._lead = self._ranks[0]
        self._remote = [r for r in self._ranks if r != _FRONT]
        self._place_params()

    # -- mesh plumbing ------------------------------------------------------

    def _check_divisibility(self):
        tp = int(self.layout.mesh.axis_size(self.layout.tp_axis))
        H = self._dec._n_heads
        if H % tp:
            raise ValueError(
                f"ShardedSlotDecoder: n_heads={H} not divisible by "
                f"tp={tp} — the K/V pools shard on the head axis")
        blk = self._dec._model.blocks[0]
        # row-parallel products cut input features (the last dim of the
        # (out, in) weight); column-parallel ffn1 cuts its output
        for name, w, dim in (("qkv_w", blk.attn.qkv.weight, -1),
                             ("proj_w", blk.attn.proj.weight, -1),
                             ("ffn1_w", blk.ffn.ffn1.weight, 0),
                             ("ffn2_w", blk.ffn.ffn2.weight, -1)):
            size = int(w.shape[dim])
            if size % tp:
                raise ValueError(
                    f"ShardedSlotDecoder: {name} sharded dim {size} "
                    f"not divisible by tp={tp}")

    def _fingerprint(self):
        """The model's weights by address AND version: a tensor replaced,
        or written in place (``Parameter.set_data``), both change it — the
        blocks are copies, so an in-place write must re-place them."""
        ptrs, stack = [], [self._dec._model]
        while stack:
            m = stack.pop()
            ptrs.extend((p.data_ptr(), p._version)
                        for p in m._parameters.values() if p is not None)
            stack.extend(m._modules.values())
        return tuple(ptrs)

    def _shard_cfg(self):
        """What a rank needs to build its share (sent in the "new"
        record)."""
        m, mesh, lay = self._dec._model, self.layout.mesh, self.layout
        order = _leaf_order(m)
        dtypes = {t.dtype for _p, _l, t in order}
        if len(dtypes) != 1:
            raise ValueError(f"ShardedSlotDecoder: the model's weights mix "
                             f"dtypes {sorted(map(str, dtypes))}")
        blocks_of = {r: [tuple(_cut(t, lay.leaf_spec(p), mesh,
                                    _coords(mesh, r)).shape)
                         for p, _l, t in order] for r in self._ranks}
        return {
            "ranks": self._ranks, "devices": mesh.devices.tolist(),
            "axis_names": mesh.axis_names, "rules": lay.rules,
            "tp_axis": lay.tp_axis, "fsdp_axis": lay.fsdp_axis,
            "n_heads": self._dec._n_heads, "units": self._dec._units,
            "eps": [(b.ln1._epsilon, b.ln2._epsilon) for b in m.blocks],
            "eps_f": m.ln_f._epsilon, "tie": bool(m._tie),
            "max_length": int(m.max_length), "impl": self._dec._impl,
            "order": [(p, l) for p, l, _t in order],
            "whole": {p: tuple(t.shape) for p, _l, t in order},
            "blocks_of": blocks_of, "dtype": dtypes.pop(),
            "device_type": self._device.type,
            "engine": dict(
                max_slots=self.max_slots, max_len=self.max_len,
                page_tokens=self.page_tokens,
                prefill_chunk=self.prefill_chunk, n_pages=self.n_pages,
                kv_dtype=self.kv_dtype, prefix_reuse=False,
                do_sample=self._do_sample, top_k=self._top_k,
                spec_k=self.spec_k, draft="ngram"),
        }

    def _blocks(self, rank):
        m, mesh = self._dec._model, self.layout.mesh
        coords = _coords(mesh, rank)
        return [_cut(t.detach(), self.layout.leaf_spec(p), mesh, coords)
                for p, _l, t in _leaf_order(m)]

    def _send_blocks(self):
        import torch.distributed as tdist

        for r in self._remote:
            flat = torch.cat([b.reshape(-1).cpu() for b in self._blocks(r)])
            tdist.send(flat, dst=r, group=_ctl())

    def _open(self):
        """Make the engine's shards: the "new" record, each rank's tp
        group and blocks, and the front's own share when it is on the
        mesh."""
        self._id = next(_ENGINE_IDS)
        cfg = self._shard_cfg()
        if self._remote:
            _post((self._id, "new", cfg, None, None))
        group = None
        tp = self.layout.tp_axis
        if _FRONT in self._ranks and self.layout.mesh.axis_size(tp) > 1:
            group = self.layout.mesh.group(tp)
        self._send_blocks()
        if _FRONT in self._ranks:
            cfg = dict(cfg, rank=_FRONT)
            blocks = [b.clone(memory_format=torch.contiguous_format)
                      for b in self._blocks(_FRONT)]
            self._local = _Shard(cfg, self.layout.mesh, group, blocks,
                                 self._device)

    def _place_params(self):
        """(Re-)place the blocks iff the model's weights changed since the
        last placement — the hot-swap path. Returns whether it did."""
        fp = self._fingerprint()
        if self._id is not None and fp == self._placed_ids:
            return False
        if self._id is None:
            self._open()
        else:
            if self._remote:
                _post((self._id, "place", None, None, None))
            self._send_blocks()
            if self._local is not None:
                self._local._place(self._blocks(_FRONT))
        self._placed_ids = fp
        return True

    def _call(self, op, *args):
        """One device call on the mesh: the record to the remote ranks,
        the front's share, then the lead's result."""
        self._place_params()
        table = self._table.copy() if self._table_dirty else None
        self._table_dirty = False
        if self._remote:
            _post((self._id, op, _to_host(args), table, self.census_name))
        out = None
        if self._local is not None:
            out = self._local._execute(op, args, table, self.census_name)
        if self._lead != _FRONT:
            out = _recv_reply(self._lead)
        status, value, self._programs = out
        if status == "error":
            raise value
        self._pools_live = op not in ("release",)
        return value

    # -- the engine's device calls, sent to the mesh ------------------------

    def _refresh_params(self):
        return self._place_params()

    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        return self._call("prefill_chunk_step", int(slot),
                          onp.asarray(chunk_tokens), int(t_start),
                          onp.asarray(key), float(temperature))

    def decode_step(self, last_tok, pos, active, key, temperature):
        return self._call("decode_step", onp.asarray(last_tok),
                          onp.asarray(pos), onp.asarray(active),
                          onp.asarray(key), onp.asarray(temperature))

    def spec_verify_step(self, last_tok, drafts, pos, active, limit):
        if not self._spec_gauge:
            self._register_spec_gauge()
        return self._call("spec_verify_step", *(
            onp.asarray(a) for a in (last_tok, drafts, pos, active, limit)))

    def copy_pages_out(self, pages):
        """Whole pages (every head, gathered by the mesh's lead) of the
        pools, for any engine's `copy_pages_in`."""
        return self._call("copy_pages_out", [int(p) for p in pages])

    def copy_pages_in(self, pages, payload):
        """A peer's whole pages written into this engine's pools: each
        rank keeps its heads."""
        return self._call("copy_pages_in", [int(p) for p in pages],
                          {k: [t.detach().cpu() for t in v]
                           for k, v in payload.items() if v})

    def slot_kv(self, slot, n_tokens):
        return self._call("slot_kv", int(slot), int(n_tokens))

    def release(self):
        """Drop the pools and graphs on every rank, and the shards with
        them: the next device call makes them again (the weights are
        placed anew)."""
        if self._id is not None:
            if self._remote:
                _post((self._id, "close", (), None, self.census_name))
            if self._local is not None:
                self._local.release()
            self._programs_closed += self._programs
        self._programs = 0
        self._local = None
        self._id = self._placed_ids = None
        self._pools_live = False
        super().release()

    @property
    def cache_bytes(self):
        """The whole pool's bytes across the mesh (the reference's
        ``nbytes`` of its cut pools); 0 while the pools are not made."""
        return self.n_pages * self.page_bytes if self._pools_live else 0

    @property
    def kv_bytes_per_slot(self):
        return self.cache_bytes / self.max_slots if self._pools_live else 0

    def xla_program_count(self):
        """The mesh lead's program count (as of the last device call),
        plus that of shards released before."""
        return self._programs_closed + self._programs

    def pool_specs(self):
        return self.layout.pool_spec(), self.layout.scale_spec()

    def shardcheck_report(self, mesh=None, hbm_budget_gb=None, bucket=None):
        """`SlotDecoder.shardcheck_report` on the mesh: every rank runs
        the pre-flight over its blocks and pools against the layout (the
        spec tier reads the whole shapes), and the lead's report is
        returned. ``mesh`` must be this engine's (or None)."""
        if mesh is not None and mesh is not self.layout.mesh:
            raise ValueError("ShardedSlotDecoder.shardcheck_report runs on "
                             "the engine's own mesh")
        if hbm_budget_gb is None:
            hbm_budget_gb = self.hbm_budget_gb
        return self._call("shardcheck_report", None, hbm_budget_gb, bucket)

    def hbm_crosscheck(self, mesh=None):
        """`SlotDecoder.hbm_crosscheck` on the mesh's lead rank: its census
        owners against its SC006 estimate."""
        if mesh is not None and mesh is not self.layout.mesh:
            raise ValueError("ShardedSlotDecoder.hbm_crosscheck runs on the "
                             "engine's own mesh")
        return self._call("hbm_crosscheck")
