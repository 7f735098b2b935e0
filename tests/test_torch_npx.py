"""The port's `npx` operators of the serving slice against the JAX
package's, on the same numpy-seeded inputs (CPU tensors).

Tolerance: 1e-6 abs and rel in float32 for gelu (elementwise, same
formula), 1e-5 for layer_norm (f32 reductions in different orders).
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import np as jnp_mx
from incubator_mxnet_tpu import npx as jnpx
from incubator_mxnet_tpu_torch import npx


def _x(shape, seed):
    return onp.random.RandomState(seed).normal(0, 2, shape).astype("float32")


@pytest.mark.parametrize("shape,scale", [((5, 33), 2.0), ((1,), 0.5),
                                         ((2, 3, 7), 4.0), ((64,), 1e-3),
                                         ((4, 96), 8.0), ((3, 5, 2, 9), 1.0)])
def test_activation_matches_jax(shape, scale):
    """gelu, the slice's activation: the reference's is the tanh
    approximation, and the port must not take PyTorch's default erf
    form."""
    x = _x(shape, seed=len(shape)) * onp.float32(scale / 2)
    ref = jnpx.activation(jnp_mx.array(x), act_type="gelu").asnumpy()
    got = npx.activation(torch.from_numpy(x), act_type="gelu").numpy()
    onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh", "swishy"])
def test_activation_not_ported_raises(act):
    with pytest.raises(ValueError):
        npx.activation(torch.zeros(3), act_type=act)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    got = npx.activation(x, act_type="gelu")
    torch.testing.assert_close(
        got, torch.nn.functional.gelu(x, approximate="tanh"))
    assert (got - exact).abs().max() > 1e-4


@pytest.mark.parametrize("shape,axis", [((4, 7, 96), -1), ((4, 6, 5), 1)])
def test_layer_norm_matches_jax(shape, axis):
    x = _x(shape, seed=3)
    c = shape[axis]
    r = onp.random.RandomState(4)
    g = r.normal(1, 0.2, (c,)).astype("float32")
    b = r.normal(0, 0.2, (c,)).astype("float32")
    ref = jnpx.layer_norm(jnp_mx.array(x), jnp_mx.array(g), jnp_mx.array(b),
                          axis=axis, eps=1e-5).asnumpy()
    got = npx.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), axis=axis, eps=1e-5).numpy()
    onp.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_flash_attention_valid_length():
    q, k, v = (torch.from_numpy(_x((2, 2, 9, 8), seed=s)) for s in (1, 2, 3))
    vl = torch.tensor([9, 4])
    o = npx.flash_attention(q, k, v, valid_length=vl, causal=True)
    assert o.shape == (2, 2, 9, 8) and (o[1, :, 4:] == 0).all()
