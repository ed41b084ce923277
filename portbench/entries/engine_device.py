"""``EngineCore.process_device``: each block a tensor already on the card,
its output left there (bulk transcoding).  The step is synchronised at its
end, or, where the mix gives ``in_flight`` k, queued behind at most k
steps still running on the card, so that the card is kept fed and the
host runs no further ahead than a transcoder with k blocks in flight."""

from portbench.entries.engine import EngineDriver


class Driver(EngineDriver):
    on_device = True
