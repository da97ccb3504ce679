"""Models of the port: the shared blocks, attention, the decoder stack, the
``Model`` API and the parameter bridge from the JAX package (``convert``)."""
