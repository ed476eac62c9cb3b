"""Device ms a step of the MoE layers' experts: the phases ``seq.experts``
(the routed experts' forward and each MoE block's backward, its forward
recomputed there, router and permutation included) and ``seq.shared`` (the
shared experts' forward) of the captured step's timed replay
(``utils/profiling.py::StepPhases``), read after the traced window."""

from perfbench.harness.spans import phase_ms


def read(ctx):
    experts = phase_ms("seq.experts")
    if experts is None:
        return None
    return experts + (phase_ms("seq.shared") or 0.0)
