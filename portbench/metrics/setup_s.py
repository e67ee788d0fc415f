"""setup_s (s, host clock): from the harness's start to the window's: the
program's import, CUDA's start, the kernels loaded from the checkout's
build directory (and built there by a checkout's first run), the inputs
made from the seed, and the warm-up of the cell's own shape."""


def read(run):
    return run.get("setup_s")
