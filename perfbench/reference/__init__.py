"""The plain reference of the benchmark: a frozen copy of the port's
models, losses, optimizer and train blocks (``ttsx_torch`` as of the
benchmark's first PR), float32, with every kernel replaced by its plain
maths and no mesh. It imports nothing of ``ttsx_torch``: the benchmark
loads the same weights and hands the same inputs and draws to both."""
