"""The benchmark's weights, loaded into the program's net and into the
reference's alike, so that neither side's own init is judged.

They are drawn on the run's device from the seed in one call, leaf by
leaf in sorted order of the parameter names, in the scale of the
reference's init: the first layer of each MLP (a name ending in
"layers.0.weight") and the input layers of a recurrent cell
("cell.i<gate>.weight", fed by the obs) a unit normal clipped at 2 over
sqrt(fan_in); the hidden layers of a cell ("cell.h<gate>.weight", H x H)
a unit normal over sqrt(H), the entry scale of an orthogonal init of gain
1, so that the carries depend on the history as the cells' own init
makes them; every other matrix a unit normal times
0.01 / sqrt(max(fan_in, fan_out)), the scale of an orthogonal init of
gain 0.01; the action std ("std") at the configuration's init_noise_std;
every other vector zero, as the biases start.
"""
from __future__ import annotations

import math
import re

import torch

# a recurrent cell's input (i) or hidden (h) layer (models/networks.py
# GRUCell, LSTMCell)
CELL_LAYER = re.compile(r"(?:^|\.)cell\.([ih])[a-z]\.weight$")


def draw(shapes: dict, seed: int, init_noise_std: float, device) -> dict:
    """{name: tensor} for the parameter shapes {name: shape}."""
    dev = torch.device(device)
    names = sorted(shapes)
    mats = [n for n in names if len(shapes[n]) == 2]
    z = torch.randn(sum(math.prod(shapes[n]) for n in mats),
                    generator=torch.Generator(dev).manual_seed(seed),
                    device=dev)
    out, i = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        if len(shape) == 2:
            fan_out, fan_in = shape
            w = z[i:i + fan_out * fan_in].view(shape)
            i += fan_out * fan_in
            cell = CELL_LAYER.search(n)
            if n.endswith("layers.0.weight") or (cell and cell[1] == "i"):
                out[n] = w.clamp(-2.0, 2.0) / math.sqrt(fan_in)
            elif cell:
                out[n] = w / math.sqrt(fan_in)
            else:
                out[n] = w * (0.01 / math.sqrt(max(fan_in, fan_out)))
        elif n == "std":
            out[n] = torch.full(shape, float(init_noise_std), device=dev)
        else:
            out[n] = torch.zeros(shape, device=dev)
    return out


def shapes_of(net) -> dict:
    return {n: tuple(p.shape) for n, p in net.named_parameters()}


@torch.no_grad()
def load(net, seed: int, init_noise_std: float) -> dict:
    """Draw the weights for `net`'s parameters on their device and copy
    them in place (the optimizers keep their references); returns them."""
    dev = next(net.parameters()).device
    w = draw(shapes_of(net), seed, init_noise_std, dev)
    for n, p in net.named_parameters():
        p.copy_(w[n])
    return w
