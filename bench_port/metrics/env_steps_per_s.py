"""env_steps_per_s: the env-steps of every call in the window over the
synchronized seconds of the window (host clock)."""


def read(run):
    return run.calls * run.env_steps / run.window_s
