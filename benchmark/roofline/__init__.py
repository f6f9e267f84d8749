"""One module per hand-written kernel: what one of its launches has to read,
write and compute, as functions of the shapes and data the launch takes.
Each module gives ``EVENT`` (a part of the kernel's name in torch.profiler's
trace), ``launch_inputs(model, sim)`` (the launch's inputs worked out by the
reference from a state of the program, in the reference's types) and
``counts(...)`` / ``bound(inputs, peaks)``."""
