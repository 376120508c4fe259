"""setup_s: process start to the end of the first call, which warms up
every shape of the window: the kernels' build (or the library an earlier
run built), terrain, env, runner, the benchmark's weights and that call,
less the host copies that the correctness check keeps of it (host
clock)."""


def read(run):
    return run.setup_s
