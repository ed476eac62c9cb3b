"""Device ms of the captured train step's ``optimizer`` phase in the last
replay of its timed graph (once in 64 replays, never traced): CUDA timing
events at the phase's two boundaries
(``utils/profiling.py::StepPhases``, marked in ``training/device_loop.py``
and ``training/sparse.py``), read after the traced window."""

from perfbench.harness.spans import phase_ms


def read(ctx):
    return phase_ms("optimizer")
