"""The port's Inception v3 (BatchNorm ``epsilon=0.001``, 299 x 299)
against the JAX package's: the reference's own configuration, the same
weights in both (the port's, random running statistics included, loaded
into the reference by name), one 299 x 299 image, logits compared in
predict mode. See `test_torch_vision_zoo` for the tolerance."""
from test_torch_vision_ops import _close
from test_torch_vision_zoo import LOGIT_TOL, carried_pair, predict_logits


def test_inception_v3_matches_reference(tmp_path):
    jnet, tnet, x = carried_pair(lambda v: v.Inception3(classes=10),
                                 (1, 3, 299, 299), tmp_path, seed=5)
    eps = {p._epsilon for p in tnet.modules()
           if type(p).__name__ == "BatchNorm"}
    assert eps == {0.001}
    got, want = predict_logits(jnet, tnet, x)
    _close(got, want, LOGIT_TOL, "inception_v3")
