"""A value computed once per test session, across pytest-xdist's workers.

The first worker to ask computes it and pickles it under the session's
base temporary directory (the parent of the workers' own), while it holds
a file lock; the others wait on the lock and load the pickle.  Several
test files read one JAX reference this way, so that splitting a file for
xdist's scheduling does not compile its reference twice.  Without xdist
the base temporary directory is the session's own.
"""
import fcntl
import os
import pickle


def once(tmp_path_factory, name, compute):
    """compute() the first time `name` is asked for in this session; its
    pickled result after that, in any worker."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        part = root / f"{name}.pkl.part"
        with open(part, "wb") as f:
            pickle.dump(value, f)
        os.replace(part, path)
        return value
