"""``mx.nd.contrib`` (port of `incubator_mxnet_tpu/ndarray/contrib.py`): the
legacy ``mx.nd.contrib.<name>`` spellings forwarded to the `npx` ops (and
`mx.np`'s ``allclose``) that hold them.

The reference forwards the whole contrib corpus. The names of it that
are not ported (the detection, box, graph, spectral and CTC families)
raise :class:`MXNetError` naming `ROADMAP.md` §1 item 11b, not
``AttributeError``; ``dir()`` lists the forwarded names only.
"""
from __future__ import annotations

from ..base import MXNetError

_ITEM_11B = "ROADMAP.md §1 item 11b (the rest of the breadth)"

# forwarded: legacy name -> npx (or np) name
_FORWARD = {
    "quadratic": "quadratic", "index_copy": "index_copy",
    "index_array": "index_array", "gradientmultiplier": "gradientmultiplier",
    "dynamic_reshape": "dynamic_reshape", "round_ste": "round_ste",
    "sign_ste": "sign_ste", "boolean_mask": "boolean_mask",
    "interleaved_matmul_selfatt_qk": "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt": "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk": "interleaved_matmul_encdec_qk",
    "interleaved_matmul_encdec_valatt": "interleaved_matmul_encdec_valatt",
    "div_sqrt_dim": "div_sqrt_dim", "sldwin_atten_score":
    "sldwin_atten_score", "sldwin_atten_context": "sldwin_atten_context",
    "sldwin_atten_mask_like": "sldwin_atten_mask_like",
    "allclose": "allclose", "arange_like": "arange_like",
    # the vision path's (ROADMAP.md §1 item 11a)
    "AdaptiveAvgPooling2D": "adaptive_avg_pooling2d",
    "BatchNormWithReLU": "batch_norm_with_relu",
    "DeformableConvolution": "deformable_convolution",
    "ModulatedDeformableConvolution": "modulated_deformable_convolution",
}

# the reference's other contrib names
_NOT_PORTED = frozenset(
    "edge_id getnnz dgl_adjacency dgl_subgraph dgl_csr_neighbor_uniform_sample "
    "dgl_csr_neighbor_non_uniform_sample dgl_graph_compact count_sketch "
    "hawkesll ctc_loss box_iou box_nms box_encode box_decode proposal "
    "multi_proposal psroi_pooling deformable_psroi_pooling rroi_align "
    "mrcnn_mask_target bipartite_matching MultiBoxPrior MultiBoxDetection "
    "MultiBoxTarget ROIAlign BilinearResize2D SyncBatchNorm fft ifft "
    "PSROIPooling DeformablePSROIPooling RROIAlign Proposal "
    "MultiProposal".split())

__all__ = sorted(_FORWARD)


def __getattr__(name):
    if name in _FORWARD:
        from .. import numpy as _np
        from .. import numpy_extension as npx

        target = _FORWARD[name]
        fn = getattr(npx, target, None)
        return fn if fn is not None else getattr(_np, target)
    if name in _NOT_PORTED:
        raise MXNetError(f"mx.nd.contrib.{name} is not ported yet "
                         f"({_ITEM_11B})")
    raise AttributeError(f"module 'nd.contrib' has no attribute {name!r}")


def __dir__():
    return sorted(_FORWARD)
