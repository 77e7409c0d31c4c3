"""setup_s: seconds from the process's start to the window's: imports,
the CUDA context, the kernels loaded (built, on a checkout's first run),
the inputs made from the seed, the coder made and every burst warmed."""


def read(rec, metric):
    return rec.setup_s
