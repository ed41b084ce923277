"""Tools that measure the port: ``quality_cuda``, the quality record of
the port's output on the card."""
