"""The paper's CNNs: conv spec tables (``specs``) and the forward pass (``cnn``)."""
