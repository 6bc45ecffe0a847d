"""Device milliseconds an engine step loses to the discriminators'
spectral norms (one an ``SNConv`` forward): the kernels launched inside
the program's ``nn.spectral_normalize`` spans, plus the device idle the
trace names after them (the host in the norm's own Python between its
operators), over the program's ``train.step`` spans
(``program_spans.per_step_range``). Caching the norm removes both."""
from perfbench.program_spans import per_step_range


def read(record):
    return per_step_range(record, "nn.spectral_normalize", idle=True)
