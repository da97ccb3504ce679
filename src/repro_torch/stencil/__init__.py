"""The paper's blocked Jacobi solver on the port (``stencil.jacobi``)."""
