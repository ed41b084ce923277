"""Tools that measure or check the port: ``quality_cuda``, the quality
record of the port's output on the card, and ``mutation_check``, which
shows that the port's tests catch injected bugs."""
