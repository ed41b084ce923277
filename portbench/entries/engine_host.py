"""``EngineCore.process``: each block from a host numpy array, its output
returned as a numpy array on the host (a media server's per-frame call)."""

from portbench.entries.engine import EngineDriver


class Driver(EngineDriver):
    on_device = False
