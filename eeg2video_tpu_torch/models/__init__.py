"""The port's models as ``nn.Module``s; the EEG encoder family is exported
here, as the JAX package's ``models`` exports it."""

from .encoders import (  # noqa: F401
    Conformer,
    DeepNet,
    EEGNet,
    GLFNet,
    GLFNetMLP,
    GLMNet,
    MLPNet,
    ShallowNet,
    ShallowNetFlexible,
    TSConv,
    make_encoder,
)
