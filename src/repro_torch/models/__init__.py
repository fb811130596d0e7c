"""The paper's CNNs (``specs``, ``cnn``) and the LM serving stack (``layers``, ``transformer``)."""
