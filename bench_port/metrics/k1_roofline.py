"""k1_roofline: the physics kernel K1's bound over its measured time, in
%, over its launches in the traced calls (counts/kernels.py)."""
from harness import roofline


def read(run):
    return roofline.share(run, ("K1",))
