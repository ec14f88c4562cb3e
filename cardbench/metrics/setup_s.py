"""setup_s (s): from process start to the first call of the window:
data and scene generation, the build or bake, the kernel library (its
build on a checkout's first run), the warm-up calls."""


def read(run):
    return run.setup_s
