"""Device milliseconds an engine step spends in the vocoder block's
discriminator steps: the kernels launched inside the program's
``gan.disc_step`` spans, over its ``train.step`` spans
(``program_spans.per_step_range``)."""
from perfbench.program_spans import per_step_range


def read(record):
    return per_step_range(record, "gan.disc_step")
