"""The program's device memory peak over the window's calls, in GiB:
``torch.cuda.max_memory_allocated()`` reset before each call, less the
answers that the benchmark holds on the device to judge after the
window.  It counts the run's panels, which a user holds too."""


def read(run):
    return run.program_peak / 2 ** 30 if run.program_peak > 0 else None
