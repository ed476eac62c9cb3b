"""Device ms a step of the sequence tower's attention blocks (norm, MLA,
residual; forward, and backward with the forward recomputed there): the
phases ``seq.attention`` of the captured step's timed replay
(``utils/profiling.py::StepPhases``, marked in ``models/seq_tower.py``),
read after the traced window."""

from perfbench.harness.spans import phase_ms


def read(ctx):
    return phase_ms("seq.attention")
