"""Neural-network layers (``mx.gluon.nn``) of the port."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .extra_layers import *  # noqa: F401,F403
from .activations import __all__ as _acts
from .basic_layers import __all__ as _basic
from .conv_layers import __all__ as _conv
from .extra_layers import __all__ as _extra

__all__ = list(_basic) + list(_acts) + list(_conv) + list(_extra)
