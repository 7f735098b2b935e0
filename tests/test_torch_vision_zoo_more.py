"""The port's VGG (with and without BatchNorm), AlexNet, SqueezeNet 1.0
and 1.1, MobileNet V2 and DenseNet against the JAX package's (MobileNet
V1 is held with its trained weights in `test_torch_vision_store`): a
narrow (or, where the constructor takes no width, the reference's own)
configuration of each, the same weights in both (the port's, random
running statistics included, loaded into the reference by name), logits
compared in predict mode (the families with ``Dropout`` leave it out
there: the two frameworks draw different bits). See
`test_torch_vision_zoo` for the tolerance."""
import pytest

from test_torch_vision_ops import _close
from test_torch_vision_zoo import LOGIT_TOL, carried_pair, predict_logits

FAMILIES = {
    "vgg": (lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16], classes=10),
            (2, 3, 32, 32)),
    "vgg_bn": (lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                               classes=10, batch_norm=True), (2, 3, 32, 32)),
    "alexnet": (lambda v: v.AlexNet(classes=10), (2, 3, 64, 64)),
    "squeezenet1.0": (lambda v: v.SqueezeNet("1.0", classes=10),
                      (2, 3, 64, 64)),
    "squeezenet1.1": (lambda v: v.SqueezeNet("1.1", classes=10),
                      (2, 3, 64, 64)),
    "mobilenetv2_0.25": (lambda v: v.MobileNetV2(0.25, classes=10),
                         (2, 3, 32, 32)),
    "densenet": (lambda v: v.DenseNet(8, 4, [2, 2], classes=10),
                 (2, 3, 64, 64)),
}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_family_matches_reference(case, tmp_path):
    make, shape = FAMILIES[case]
    jnet, tnet, x = carried_pair(make, shape, tmp_path, seed=3)
    got, want = predict_logits(jnet, tnet, x)
    assert got.shape == (shape[0], 10)
    _close(got, want, LOGIT_TOL, case)
