"""setup_s: seconds from process start to the first timed request:
imports, the CUDA context, loading the kernels, making the graphs and the
warm-up request."""


def read(w):
    return w.setup_s
