"""kernels_roofline: the sum of the bounds of every launch of the port's
hand-written kernels (K1-K9) in the traced calls over the sum of their
measured times, in %."""
from counts.kernels import KERNELS
from harness import roofline


def read(run):
    return roofline.share(run, tuple(KERNELS))
