"""The controls at a size a CPU test run holds: the program at each
precision tier below the configuration's, and the reference computed in
TF32 in the program's place, each come out not correct.  (On the card,
``portbench/control.py`` reads them at each cell's own size.)"""

import pytest

from portbench.tests.small import CELLS, run


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", [{"tier": "high"}, {"tier": "default"},
                                  {"control": "tf32"}],
                         ids=["high", "default", "tf32"])
def test_control_is_not_correct(cell, mode):
    r = run(cell, **mode)
    assert not r["correct"]
    assert r["checks"]["max_rel_err"]["value"] > \
        r["checks"]["max_rel_err"]["limit"]


def test_control_tool_runs_the_controls(monkeypatch, capsys):
    """``control.py`` refuses to run without a card."""
    from portbench import control
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert control.main(["--workload", "opus48.serve", "--seeds", "1"]) == 2
